"""The port's data layer against the JAX package's: the dataset readers
(``data/datasets.py``), the VQA, NLVR2 and retrieval datasets, the
canvas-grouped sampler, the text preprocessing (``text/preprocess.py``,
``text/segmenter.py``), and the MLM masking and metrics
(``training/mlm.py``).

TomBERT's data (``data/tombert_dataset.py``): ``imagenet_preprocess``
against the JAX package's on noise images of odd geometries (portrait,
landscape, smaller than the crop, one side unchanged), atol 5e-6 after the
normalization (measured max 1.1e-6; the JAX package's resize is jitted, so
its sample positions are fused multiply-adds, as the port computes them),
and ``TomBertTmscDataset``'s features and batches, eager and per fetch, the
same ids, masks and labels and images within that tolerance.

The fixtures are those of tests/test_datasets.py (Twitter-201X TSV,
Bloomberg CSV, MVSA ``labelResultAll.txt``, solid-colour images) plus VQAv2
JSON, NLVR2 jsonl and retrieval images; each dataset is built by both
packages on the same files with the same WordPiece vocabulary.  Token ids,
masks, labels, names and batch order must be equal; pixel values within
one uint8 level (2/255 after normalization: the port's resize is within
one level of PIL's, ``data/image.py``).  ``mask_tokens`` draws from a
``torch.Generator``, so its properties are tested, not its stream;
``mlm_loss`` and ``mlm_accuracy`` are held to the JAX package's on the
same logits (atol 1e-6 in fp32, 1e-5 from bf16 logits).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vault_tpu.data import datasets as jds
from vault_tpu.data import loader as jloader
from vault_tpu.data import nlvr2 as jnlvr2
from vault_tpu.data import retrieval as jretrieval
from vault_tpu.data import tombert_dataset as jtombert_ds
from vault_tpu.data import vqa as jvqa
from vault_tpu.data import vqa_dataset as jvqa_ds
from vault_tpu.data.image import canvas_key as j_canvas_key
from vault_tpu.data.processor import VaultProcessor as JProcessor
from vault_tpu.text import preprocess as jpre
from vault_tpu.text import segmenter as jseg
from vault_tpu.text.wordpiece import WordPieceTokenizer as JWordPiece
from vault_tpu.training import mlm as jmlm
from vault_tpu_torch.data import datasets as tds
from vault_tpu_torch.data import loader as tloader
from vault_tpu_torch.data import nlvr2 as tnlvr2
from vault_tpu_torch.data import retrieval as tretrieval
from vault_tpu_torch.data import tombert_dataset as ttombert_ds
from vault_tpu_torch.data import vqa as tvqa
from vault_tpu_torch.data import vqa_dataset as tvqa_ds
from vault_tpu_torch.data.image import canvas_key
from vault_tpu_torch.data.processor import VaultProcessor
from vault_tpu_torch.text import preprocess as tpre
from vault_tpu_torch.text import segmenter as tseg
from vault_tpu_torch.text.wordpiece import WordPieceTokenizer
from vault_tpu_torch.training import mlm as tmlm

VOCAB = ("[PAD] [UNK] [CLS] [SEP] [MASK] the quick fox dog good bad rt "
         "user url # ! . , great awful nice a cat left image has more dogs").split()
LEVEL = 2.0 / 255 + 1e-6


def _procs(canvas=(64, 64), max_length=16):
    v = {t: i for i, t in enumerate(VOCAB)}
    return (JProcessor(JWordPiece(v), max_length=max_length, canvas=canvas),
            VaultProcessor(WordPieceTokenizer(v), max_length=max_length, canvas=canvas))


def _img(path, size=(50, 60), color=(120, 30, 200)):
    Image.new("RGB", size, color).save(path)


def _same_batches(ours, ref):
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for (fo, lo, *io), (fr, lr, *ir) in zip(ours, ref):
        assert fo.keys() == fr.keys()
        for k in fr:
            a, b = np.asarray(fo[k]), np.asarray(fr[k])
            assert a.shape == b.shape and a.dtype == b.dtype, k
            if k == "pixel_values":
                np.testing.assert_allclose(a, b, atol=LEVEL, rtol=0)
            else:
                np.testing.assert_array_equal(a, b, err_msg=k)
        np.testing.assert_array_equal(np.asarray(lo), np.asarray(lr))
        assert io == ir


@pytest.fixture
def twitter_dir(tmp_path):
    d = tmp_path / "twitter2015"
    imgs = tmp_path / "twitter2015_images"
    d.mkdir(); imgs.mkdir()
    rows = [
        ("1", "0", "a.jpg", "RT @user $T$ is great #GoodDay", "the fox"),
        ("2", "1", "b.jpg", "$T$ looked bad!!! http://t.co/x", "a dog"),
        ("3", "-1", "missing.jpg", "nothing about $T$ 😀", "the quick"),
        ("4", "1", "c.png", "so niiiice $T$", "a cat"),
    ]
    for split in ("train", "dev"):
        with open(d / f"{split}.tsv", "w") as f:
            f.write("index\t#1 Label\t#2 ImageID\t#3 String\t#3 String\n")
            for r in rows:
                f.write("\t".join(r) + "\n")
    _img(imgs / "a.jpg"); _img(imgs / "b.jpg", size=(90, 40), color=(10, 200, 30))
    _img(imgs / jds.FAIL_IMAGE_BN)
    Image.new("RGBA", (40, 70), (200, 10, 10, 100)).save(imgs / "c.png")
    return str(d)


@pytest.mark.parametrize("buckets", [False, True])
def test_twitter_dataset_matches_jax(twitter_dir, buckets):
    """Reader, sorted label mapping, image fallback (missing.jpg), the RGBA
    blend onto white (c.png), text preprocessing and an entity map, the
    canvas-grouped batches under a seeded shuffle."""
    jp, tp = _procs(canvas="auto" if buckets else (64, 64))
    kw = dict(max_length=16, orientation_buckets=buckets,
              entity_map={"the fox": "[fox]"}, augment=buckets)
    ref = jds.Twitter201XDataset(twitter_dir, ["train", "dev"], jp,
                                 text_preprocessor=jpre.twitter_preprocessor(), **kw)
    ours = tds.Twitter201XDataset(twitter_dir, ["train", "dev"], tp,
                                  text_preprocessor=tpre.twitter_preprocessor(), **kw)
    assert ours.label_mapping == ref.label_mapping == {"-1": 0, "0": 1, "1": 2}
    assert ours.name == ref.name and ours.texts == ref.texts
    assert ours._err_count == ref._err_count == 2
    assert ours.num_batches(3) == ref.num_batches(3)
    _same_batches(ours.batches(3, shuffle=True, rng=np.random.default_rng(5)),
                  ref.batches(3, shuffle=True, rng=np.random.default_rng(5)))
    for path in ("a.jpg", "c.png"):
        p = os.path.join(os.path.dirname(twitter_dir), "twitter2015_images", path)
        np.testing.assert_array_equal(tds.load_image_file(p), jds.load_image_file(p))


PREPROCESS_ATOL = 5e-6


@pytest.mark.parametrize("hw,crop", [((300, 200), 224), ((200, 333), 224), ((480, 640), 224),
                                     ((50, 40), 64), ((97, 131), 64), ((30, 500), 64),
                                     ((64, 90), 64)])
def test_imagenet_preprocess_matches_jax(hw, crop):
    """Short side to the crop (floor geometry), the round-half center
    crop, ImageNet normalization: portrait, landscape, images smaller than
    the crop (upscaled), a thin strip, and one side already at the crop."""
    img = np.random.default_rng(sum(hw)).integers(0, 256, (*hw, 3), dtype=np.uint8)
    ref = jtombert_ds.imagenet_preprocess(img, crop)
    ours = ttombert_ds.imagenet_preprocess(img, crop)
    assert ours.shape == ref.shape == (3, crop, crop) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, atol=PREPROCESS_ATOL, rtol=0)


@pytest.mark.parametrize("on_fetch", [False, True])
def test_tombert_dataset_matches_jax(twitter_dir, on_fetch):
    """Both encodings (the tweet+target pair at 16 tokens, the target at
    5), the entity map, the image fallback, eager and per-fetch images,
    the frozen-ResNet cache served in place of the images, under a seeded
    shuffle."""
    imgs = os.path.join(os.path.dirname(twitter_dir), "twitter2015_images")
    rng = np.random.default_rng(3)
    for name, hw in (("a.jpg", (70, 50)), ("b.jpg", (40, 90))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            os.path.join(imgs, name), format="PNG")
    jp, tp = _procs()
    kw = dict(max_total_length=16, max_target_length=5, crop_size=32,
              preprocess_on_fetch=on_fetch, num_workers=2,
              entity_map={"the fox": "[fox]"})
    ref = jtombert_ds.TomBertTmscDataset(twitter_dir, ["train", "dev"], jp, **kw)
    ours = ttombert_ds.TomBertTmscDataset(twitter_dir, ["train", "dev"], tp, **kw)
    assert ours.name == ref.name and ours.label_mapping == ref.label_mapping
    assert ours.num_examples == ref.num_examples == 8 and ours.num_batches(3) == 3
    for k, v in ref.features.items():
        np.testing.assert_array_equal(ours.features[k], v, err_msg=k)
    assert (ours.images is None) == (ref.images is None) == on_fetch

    def check(o, r):
        o, r = list(o), list(r)
        assert len(o) == len(r) == 3
        for (fo, lo), (fr, lr) in zip(o, r):
            assert fo.keys() == fr.keys()
            for k in fr:
                if k in ("images", "visual_embeddings"):
                    np.testing.assert_allclose(fo[k], fr[k], atol=PREPROCESS_ATOL, rtol=0)
                else:
                    np.testing.assert_array_equal(fo[k], fr[k], err_msg=k)
            np.testing.assert_array_equal(lo, lr)

    check(ours.batches(3, shuffle=True, rng=np.random.default_rng(5)),
          ref.batches(3, shuffle=True, rng=np.random.default_rng(5)))
    assert ours._err_count == ref._err_count > 0
    emb = rng.normal(size=(8, 1, 6)).astype(np.float32)
    ours.replace_images_with_embeddings(emb)
    ref.replace_images_with_embeddings(emb)
    check(ours.batches(3, shuffle=True, rng=np.random.default_rng(6)),
          ref.batches(3, shuffle=True, rng=np.random.default_rng(6)))


@pytest.fixture
def bloomberg_dir(tmp_path):
    d = tmp_path / "bloomberg"
    (d / "Twitter_images").mkdir(parents=True)
    with open(d / "bloomberg-textimage.csv", "w") as f:
        f.write("tweet_id,tweet,other,text_is_represented,image_adds\n")
        for i in range(40):
            f.write(f"{i},text {i} \\,quoted,x,{i % 2},{(i + 1) % 3 == 0:d}\n")
    for i in range(40):
        _img(d / "Twitter_images" / f"T{i}.jpg", color=(i * 6, 30, 90))
    return str(d)


@pytest.mark.parametrize("splits", ["train", "dev", ["train", "dev"], "test"])
@pytest.mark.parametrize("tasks", ["text_is_represented",
                                   ["text_is_represented", "image_adds"]])
def test_load_bloomberg_matches_jax(bloomberg_dir, splits, tasks):
    """The seed-42 split (python's random.Random(42).sample) and the label
    columns."""
    ours = tds.load_bloomberg(bloomberg_dir, splits, tasks, dev_size=4, test_size=6)
    ref = jds.load_bloomberg(bloomberg_dir, splits, tasks, dev_size=4, test_size=6)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture
def mvsa_dirs(tmp_path):
    single = tmp_path / "MVSA_Single"
    (single / "data").mkdir(parents=True)
    rows = [("1", "positive,positive"), ("2", "negative,positive"),
            ("3", "neutral,positive"), ("4", "neutral,neutral"),
            ("5", "negative,neutral"), ("6", "positive,neutral"),
            ("7", "neutral,negative"), ("8", "positive,positive"),
            ("9", "neutral,neutral"), ("10", "negative,negative"),
            ("11", "positive,negative"), ("12", "neutral,neutral")]
    with open(single / "labelResultAll.txt", "w") as f:
        f.write("ID\ttext,image\n")
        f.writelines("\t".join(r) + "\n" for r in rows)
    (single / "corrupt_ids.txt").write_text("10\n")
    multi = tmp_path / "MVSA"
    (multi / "data").mkdir(parents=True)
    with open(multi / "labelResultAll.txt", "w") as f:
        f.write("ID\ttext,image\ttext,image.1\ttext,image.2\n")
        f.write("1\tpositive,neutral\tpositive,neutral\tnegative,positive\n")
        f.write("2\tpositive,neutral\tneutral,neutral\tnegative,neutral\n")
        for i in range(3, 13):
            f.write(f"{i}\tneutral,neutral\tneutral,negative\tnegative,negative\n")
    for d in (single, multi):
        for i in range(1, 13):
            with open(d / "data" / f"{i}.txt", "w", encoding="latin1") as f:
                f.write(f"tweet {i} caf\xe9 #mynewcar\nsecond line\n")
            _img(d / "data" / f"{i}.jpg", color=(i * 20, 10, 10))
    return str(single), str(multi)


@pytest.mark.parametrize("preprocessed", [True, False])
def test_load_mvsa_and_its_dataset_match_jax(mvsa_dirs, preprocessed):
    """Corrupt ids, the annotator majority (MVSA-Multiple), the modality
    aggregation of the preprocessed labels, the seed-42 8:1:1 split; then
    ``VisionLanguageDataset`` over them with the CLI's text preprocessing."""
    for root in mvsa_dirs:
        for splits in ("train", "dev", "test", ["train", "dev", "test"]):
            ours = tds.load_mvsa(root, splits, preprocessed)
            ref = jds.load_mvsa(root, splits, preprocessed)
            for a, b in zip(ours, ref):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    ids, texts, fns, labels = tds.load_mvsa(mvsa_dirs[0], ["train", "dev"], preprocessed)
    jp, tp = _procs()
    t_pre, j_pre = tpre.twitter_preprocessor(), jpre.twitter_preprocessor()
    ours = tds.VisionLanguageDataset(ids, texts, fns, labels, tp, name="m",
                                     text_preprocessor=t_pre, max_length=16)
    ref = jds.VisionLanguageDataset(ids, texts, fns, labels, jp, name="m",
                                    text_preprocessor=j_pre, max_length=16)
    assert ours.texts == ref.texts
    _same_batches(ours.batches(4, shuffle=True, rng=np.random.default_rng(1)),
                  ref.batches(4, shuffle=True, rng=np.random.default_rng(1)))


def _equal_batches(ours, ref):
    """Batches equal bit for bit (the same resize on both sides)."""
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref)
    for (fo, lo), (fr, lr) in zip(ours, ref):
        assert fo.keys() == fr.keys()
        for k in fr:
            np.testing.assert_array_equal(np.asarray(fo[k]), np.asarray(fr[k]), err_msg=k)
        np.testing.assert_array_equal(lo, lr)


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("buckets", [False, True])
def test_lazy_twitter_dataset_matches_jax_and_eager(twitter_dir, buckets, workers):
    """``lazy_images``: the JAX package's lazy batches, and the port's eager
    ones bit for bit, under a seeded shuffle with augmentation; the canvas
    keys from file headers (the missing image's from the fallback's); the
    fallback counted at each fetch, as in the JAX package."""
    jp, tp = _procs(canvas="auto" if buckets else (64, 64))
    kw = dict(max_length=16, orientation_buckets=buckets, augment=True,
              num_workers=workers)
    ref = jds.Twitter201XDataset(twitter_dir, ["train", "dev"], jp, lazy_images=True, **kw)
    lazy = tds.Twitter201XDataset(twitter_dir, ["train", "dev"], tp, lazy_images=True,
                                  **kw)
    eager = tds.Twitter201XDataset(twitter_dir, ["train", "dev"], tp, **kw)
    assert lazy._images is None and lazy._err_count == ref._err_count == 0
    assert lazy._canvas_keys() == ref._canvas_keys() == eager._canvas_keys()
    assert lazy.num_batches(3) == ref.num_batches(3) == eager.num_batches(3)
    run = lambda ds: ds.batches(3, shuffle=True, rng=np.random.default_rng(5))
    _same_batches(run(lazy), run(ref))
    _equal_batches(run(lazy), run(eager))
    # two passes over the lazy set, one over the JAX package's
    assert lazy._err_count == 2 * ref._err_count == 2 * eager._err_count == 4


@pytest.mark.parametrize("workers", [0, 3])
@pytest.mark.parametrize("buckets", [False, True])
def test_lazy_vl_dataset_matches_jax_and_eager(tmp_path, buckets, workers):
    """``VisionLanguageDataset(lazy=True)`` over landscape and portrait
    files: the JAX package's lazy batches and the port's eager ones, the
    orientation keys from the headers."""
    paths = []
    for i in range(7):
        p = str(tmp_path / f"i{i}.jpg")
        _img(p, size=(80, 50) if i % 3 else (50, 80), color=(i * 30, 10, 5))
        paths.append(p)
    ids, texts = [str(i) for i in range(7)], ["the fox", "a good dog"] * 3 + ["a cat"]
    labels = np.arange(7, dtype=np.int32)
    jp, tp = _procs(canvas="auto" if buckets else (64, 64), max_length=8)
    kw = dict(orientation_buckets=buckets, num_workers=workers, augment=True)
    ref = jds.VisionLanguageDataset(ids, texts, paths, labels, jp, lazy=True, **kw)
    lazy = tds.VisionLanguageDataset(ids, texts, paths, labels, tp, lazy=True, **kw)
    eager = tds.VisionLanguageDataset(ids, texts, paths, labels, tp, **kw)
    assert lazy._images is None
    assert lazy._canvas_keys() == ref._canvas_keys() == eager._canvas_keys()
    assert lazy.num_batches(2) == ref.num_batches(2) == eager.num_batches(2)
    run = lambda ds: ds.batches(2, shuffle=True, rng=np.random.default_rng(2))
    _same_batches(run(lazy), run(ref))
    _equal_batches(run(lazy), run(eager))


def test_lazy_dataset_and_peek_image_size_match_jax(tmp_path):
    """``LazyDataset`` hands ``encode_batch`` the JAX package's index
    batches and train flag; ``peek_image_size`` reads (H, W) from the
    header as the JAX package's does, equal to the decoded shape."""
    seen = {"ours": [], "ref": []}

    def encode(tag):
        def enc(sel, train):
            seen[tag].append((list(sel), train))
            return {"x": np.asarray(sel)}, np.asarray(sel) % 2
        return enc

    ours, ref = tloader.LazyDataset(encode("ours"), 11), jloader.LazyDataset(encode("ref"), 11)
    assert ours.num_examples == 11 and ours.num_batches(4) == ref.num_batches(4) == 3
    for shuffle in (False, True):
        _equal_batches(ours.batches(4, shuffle, np.random.default_rng(3)),
                       ref.batches(4, shuffle, np.random.default_rng(3)))
    assert seen["ours"] == seen["ref"] and {t for _, t in seen["ours"]} == {False, True}
    for size in ((80, 50), (33, 120)):
        p = str(tmp_path / f"{size[0]}.png")
        _img(p, size=size)
        assert tloader.peek_image_size(p) == jloader.peek_image_size(p) \
            == tds.load_image_file(p).shape[:2] == (size[1], size[0])


def test_grouped_batch_indices_and_canvas_keys_match_jax():
    keys = ["a", "b", "a", "a", "b", "c", "a", "b", ("x", 1), ("x", 1)]
    for shuffle in (False, True):
        for bs in (1, 2, 3):
            ours = tloader.grouped_batch_indices(keys, bs, shuffle,
                                                 np.random.default_rng(bs))
            ref = jloader.grouped_batch_indices(keys, bs, shuffle,
                                                np.random.default_rng(bs))
            assert [b.tolist() for b in ours] == [b.tolist() for b in ref]
    for h in (10, 50, 384, 600, 700, 1000, 5000):
        for w in (10, 60, 384, 640, 900, 6000):
            assert canvas_key(h, w) == j_canvas_key(h, w), (h, w)


TWEETS = [
    "RT @JohnDoe check https://t.co/xyz #GreatDay!!",
    "I can't believe it's sooooo good *really* #mynewcar #iphone7 :) <3",
    "Call 555-123-4567 or mail a.b@c.com, we'll be there!!!???",
    "#BlackLivesMatter f**k this #sunset_beach 2000 $5.99",
    "won't they've I'm you'd 😀🎉 ©™ 東京 ❤️",
]


def test_text_preprocessing_matches_jax():
    """The twitter preprocessor (default and custom tags), the per-LM
    demojizers and the hashtag segmenter, whose tables the port reads from
    its own directory."""
    assert tseg._DATA_DIR.endswith(os.path.join("vault_tpu_torch", "text", "data"))
    for kw in ({}, {"normalized_tags": ["url"], "extra_tags": ["elongated"]}):
        ours, ref = tpre.twitter_preprocessor(**kw), jpre.twitter_preprocessor(**kw)
        for t in TWEETS:
            assert ours(t) == ref(t), t
    for name in ("bert-base-uncased", "vinai/bertweet-base", "other"):
        ours, ref = tpre.demojizer_selector(name), jpre.demojizer_selector(name)
        for t in TWEETS:
            assert ours(t) == ref(t), (name, t)
    seg, jseg_ = tseg.default_segmenter(), jseg.default_segmenter()
    for s in ("mynewcar", "sunsetbeach", "bertweet", "greatday", "iloveyou", "x"):
        assert seg.segment(s) == jseg_.segment(s), s


ANSWERS = ["Two", "two.", "three", "the dog", "a  cat,", "none", "yes!", "it's",
           "isnt", "1,000", "5.5", "left"]


def test_vqa_answers_and_dataset_match_jax(tmp_path):
    """Answer normalization and soft scores, the answer vocabulary, the
    ``label_weights`` feature (0 for a question without a usable answer or
    without annotations)."""
    for a in ANSWERS:
        assert tvqa.normalize_word(a) == jvqa.normalize_word(a), a
    l2i = {"2": 0, "3": 1, "dog": 2, "cat": 3}
    np.testing.assert_array_equal(tvqa.answer_scores(ANSWERS, l2i, 4),
                                  jvqa.answer_scores(ANSWERS, l2i, 4))
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i in (1, 2, 3):
        _img(img_dir / f"{i}.jpg", size=(48, 48), color=(i * 60, 90, 30))
    qs = [{"question_id": 10 + i, "image_id": 1 + i % 3, "question": q}
          for i, q in enumerate(["a cat", "a dog", "left image", "the fox", "nice"])]
    anns = [{"question_id": 10, "image_id": 1,
             "answers": [{"answer": "Two"}] * 4 + [{"answer": "three"}] * 6},
            {"question_id": 11, "image_id": 2, "answers": [{"answer": "the dog"}] * 10},
            {"question_id": 12, "image_id": 3, "answers": [{"answer": "zebra"}] * 10},
            {"question_id": 13, "image_id": 1,
             "answers": [{"answer": a} for a in ANSWERS[:10]]}]
    (tmp_path / "q.json").write_text(json.dumps({"questions": qs}))
    (tmp_path / "a.json").write_text(json.dumps({"annotations": anns}))
    jp, tp = _procs(canvas=(48, 48), max_length=8)
    files = (str(tmp_path / "q.json"), str(tmp_path / "a.json"), str(img_dir))
    for l2i in (None, {"2": 0, "3": 1, "dog": 2}):
        ours = tvqa_ds.VqaDataset(*files, tp, label2id=l2i, max_length=8)
        ref = jvqa_ds.VqaDataset(*files, jp, label2id=l2i, max_length=8)
        assert ours.label2id == ref.label2id and ours.num_labels == ref.num_labels
        np.testing.assert_array_equal(ours.label_weights, ref.label_weights)
        assert ours.label_weights.tolist() == ref.label_weights.tolist()
        # question 14 has no annotation; 12's answer is outside the given vocab
        assert ours.label_weights[4] == 0.0 and (l2i is None or ours.label_weights[2] == 0.0)
        _same_batches(ours.batches(2, shuffle=True, rng=np.random.default_rng(2)),
                      ref.batches(2, shuffle=True, rng=np.random.default_rng(2)))
    with pytest.raises(ValueError, match="annotations or label2id"):
        tvqa_ds.VqaDataset(files[0], None, files[2], tp)


def test_nlvr2_dataset_matches_jax(tmp_path):
    """Two images per example, one encode over both slots, (B, 2, C, H, W)."""
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    recs = []
    for i in range(5):
        for s in (0, 1):
            _img(img_dir / f"dev-{i}-0-img{s}.png", size=(40 + 10 * s, 40),
                 color=(i * 30, 80, 10 + s * 100))
        recs.append({"identifier": f"dev-{i}-0-{i % 2}",
                     "sentence": "the left image has more dogs",
                     "label": "True" if i % 2 == 0 else "false"})
    jsonl = tmp_path / "dev.jsonl"
    jsonl.write_text("\n".join(json.dumps(r) for r in recs) + "\n\n")
    jp, tp = _procs(canvas=(32, 32), max_length=10)
    ours = tnlvr2.Nlvr2Dataset(str(jsonl), str(img_dir), tp, max_length=10)
    ref = jnlvr2.Nlvr2Dataset(str(jsonl), str(img_dir), jp, max_length=10)
    assert ours.identifiers == ref.identifiers and ours.image_pairs == ref.image_pairs
    assert ours.labels.tolist() == ref.labels.tolist() == [1, 0, 1, 0, 1]
    _same_batches(ours.batches(2, shuffle=True, rng=np.random.default_rng(3)),
                  ref.batches(2, shuffle=True, rng=np.random.default_rng(3)))
    f, _ = next(ours.batches(4))
    assert f["pixel_values"].shape == (4, 2, 3, 32, 32) and f["pixel_mask"].shape == (4, 2, 32, 32)


@pytest.mark.parametrize("canvas", [(64, 64), "auto"])
def test_retrieval_dataset_matches_jax(tmp_path, canvas):
    """Training pairs with sampled negatives (the same draws from the
    dataset's seed) and the exhaustive text x image product with
    identifiers, from the per-image pixel cache."""
    paths = []
    for i in range(4):
        p = tmp_path / f"{i}.jpg"
        _img(p, size=(60 + 20 * i, 50), color=(i * 50, 20, 200))
        paths.append(str(p))
    texts = ["a cat", "a dog", "the fox", "left image"]
    jp, tp = _procs(canvas=canvas, max_length=8)
    ours = tretrieval.RetrievalDataset(["a", "b", "c", "d"], texts, paths, tp,
                                       max_length=8, negatives_per_positive=2, seed=4)
    ref = jretrieval.RetrievalDataset(["a", "b", "c", "d"], texts, paths, jp,
                                      max_length=8, negatives_per_positive=2, seed=4)
    assert ours.num_examples == ref.num_examples == 12
    _same_batches(ours.batches(5, shuffle=True), ref.batches(5, shuffle=True))
    _same_batches(ours.all_pairs_batches(6), ref.all_pairs_batches(6))


def test_mask_tokens_properties():
    """Special tokens are never selected; about 15% of the rest are; of the
    selected, about 80% become [MASK], 10% a random id, 10% stay; labels
    hold the originals there and IGNORE elsewhere (at a fixed seed, within
    a few standard errors)."""
    gen = torch.Generator().manual_seed(0)
    ids = torch.from_numpy(np.random.default_rng(0).integers(5, 90, (64, 128)))
    special = torch.zeros_like(ids)
    special[:, 0] = 1
    special[:, -3:] = 1
    masked, labels = tmlm.mask_tokens(gen, ids, special, mask_token_id=4, vocab_size=99)
    assert masked.dtype == ids.dtype and labels.shape == ids.shape
    sel = labels != tmlm.IGNORE
    assert not sel[special.bool()].any()
    n_sel = int(sel.sum())
    frac = n_sel / int((special == 0).sum())
    assert abs(frac - 0.15) < 0.02, frac
    assert torch.equal(labels[sel], ids[sel]) and torch.equal(masked[~sel], ids[~sel])
    to_mask = (masked[sel] == 4).float().mean().item()
    kept = (masked[sel] == ids[sel]).float().mean().item()
    assert abs(to_mask - 0.8) < 0.04 and abs(kept - 0.1 - 0.1 / 99) < 0.03, (to_mask, kept)
    assert tmlm.IGNORE == jmlm.IGNORE
    again = tmlm.mask_tokens(torch.Generator().manual_seed(0), ids, special, 4, 99)
    assert torch.equal(again[0], masked) and torch.equal(again[1], labels)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mlm_loss_and_accuracy_match_jax(dtype, weighted):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(4, 10, 20)).astype(np.float32) * 2
    labels = rng.integers(0, 20, (4, 10))
    labels[:, ::2] = jmlm.IGNORE
    labels[0, 1] = int(np.argmax(logits[0, 1]))  # at least one hit
    weight = np.array([1, 0, 1, 1], np.float32) if weighted else None
    jl = jnp.asarray(logits, getattr(jnp, dtype))
    tl = torch.from_numpy(logits).to(getattr(torch, dtype))
    ref = jmlm.mlm_loss(jl, jnp.asarray(labels),
                        None if weight is None else jnp.asarray(weight))
    ours = tmlm.mlm_loss(tl, torch.from_numpy(labels),
                         None if weight is None else torch.from_numpy(weight))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.item(), float(ref),
                               atol=1e-6 if dtype == "float32" else 1e-5)
    acc = tmlm.mlm_accuracy(tl, torch.from_numpy(labels))
    assert acc.item() == pytest.approx(float(jmlm.mlm_accuracy(jl, jnp.asarray(labels))))
