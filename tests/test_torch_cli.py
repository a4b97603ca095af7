"""The port's command-line entry points (``vault_tpu_torch/cli/``) against the
JAX package's ``scripts/serve.py``, ``scripts/quantize_ckpt.py`` and
``experiments/clsf_vault.py``.

A w8a8 checkpoint written by the JAX package (``vault_tpu.ops.quantize`` +
``vault_tpu.training.checkpoint``) is served by the port's ``build``
(``--device cpu --debug_tiny``); its logits are held against the JAX
package's forward on the same parameters and the same processed batch, on
the JAX serving selector ("fuselnqkv+fusemlp", the Pallas kernels
interpreted).  Tolerance: atol 1e-3 plus rtol 2^-7.  ``test_torch_quantize``
holds one w8a8 ``linear`` to one bf16 ulp (rtol 2^-7); a whole bf16 forward
rounds its elementwise chains in XLA and in torch at different points (the
bf16 model tests allow 3e-2), so the logits (about 0.06 here) differ by one
or two bf16 ulps of their scale: measured at most 4.9e-4 at seeds 0-3.  The
port's quantized npz must restore in the JAX package bit-equal to the JAX
package's own quantization, and the HTTP server answers as
``tests/test_serving.py`` asks of the JAX script.
"""

import base64
import io
import json
import os
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vault_tpu.config import debug_tiny_vault_config as j_debug_tiny
from vault_tpu.models import vault as jvault
from vault_tpu.ops import quantize as jq
from vault_tpu.training import checkpoint as jckpt
from vault_tpu_torch.cli import quantize_ckpt, serve
from vault_tpu_torch.ops.quantize import is_k_major

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL, RTOL = 1e-3, 2.0 ** -7
CLIS = ["vault_tpu_torch.cli.serve", "vault_tpu_torch.cli.quantize_ckpt",
        "vault_tpu_torch.cli.clsf_vault", "vault_tpu_torch.cli.tmsc_tombert"]


def _jax_params(seed=0, n_classes=3):
    """The JAX package's --debug_tiny VAuLT with every leaf moved off its
    init (zero biases, unit LayerNorms), fp32."""
    cfg = j_debug_tiny()
    p = jvault.init_vault(jax.random.PRNGKey(seed), cfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(1), cfg.vilt.hidden_size,
                                            n_classes)
    leaves, tree = jax.tree.flatten(p)
    rng = np.random.default_rng(7 + seed)
    leaves = [l + jnp.asarray(0.02 * rng.normal(size=l.shape), l.dtype) for l in leaves]
    return cfg, jax.tree.unflatten(tree, leaves)


def _cast_bf16(tree):
    return jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def _args(*extra):
    return serve.parse_args(["--debug_tiny", "--device", "cpu", "--port", "0",
                             "--max_batch", "2", *extra])


def _batch(processor, seed=0):
    rng = np.random.default_rng(seed)
    images = [rng.integers(0, 256, (60 + 7 * i, 90, 3), dtype=np.uint8) for i in range(3)]
    return processor(images, ["a cat sits on the couch", "the dog", "x y z"])


@pytest.mark.parametrize("cli", CLIS)
def test_help_renders(cli):
    res = subprocess.run([sys.executable, "-m", cli, "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "usage: python -m " + cli in res.stdout
    if cli.endswith("serve"):
        assert "12.5-16.7%" in res.stdout and "--device" in res.stdout
        for flag in ("--dp", "--tp", "--pp"):
            assert flag in res.stdout, flag


@pytest.mark.parametrize("seed", [0, 1])
def test_jax_w8a8_checkpoint_serves_in_the_port(tmp_path, seed):
    """scripts/serve.py's deployment flow across packages: the JAX package
    quantizes and saves; the port detects w8a8 from the keys, restores with
    the MLP codes K-major, and serves the JAX package's logits."""
    cfg, p = _jax_params(seed)
    qp = jq.quantize_model_params(_cast_bf16(p), mode="w8a8")
    jckpt.save_checkpoint(str(tmp_path / "jax_w8a8"), {"params": qp})
    model, processor, server = serve.build(_args("--ckpt", str(tmp_path / "jax_w8a8")))
    server.close()
    assert model.quant_mode == "w8a8" and model.use_pallas == "fuselnqkv+fusemlp"
    assert all(is_k_major(lp[n]["w_q8"]) for tower in ("vilt", "bert")
               for lp in model[tower]["layers"] for n in ("mlp_in", "mlp_out"))
    enc = _batch(processor, seed)
    with torch.inference_mode():
        out = model(enc).float().numpy()
    ref = jvault.vault_for_classification(
        qp, cfg, {k: jnp.asarray(np.asarray(v)) for k, v in enc.items()}, head_dropout=0.0,
        deterministic=True, use_pallas="fuselnqkv+fusemlp")
    np.testing.assert_allclose(out, np.asarray(ref.astype(jnp.float32)), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("mode", ["w8", "w8a8"])
def test_port_quantized_checkpoint_restores_in_jax(tmp_path, mode):
    """quantize_ckpt on a JAX-written fp checkpoint: the output restores in
    the JAX package bit-equal to its own cast-then-quantize of the same
    parameters, bf16 leaves as bf16 and codes in their logical layout."""
    _, p = _jax_params(2)
    jckpt.save_checkpoint(str(tmp_path / "fp"), {"params": p})
    line = quantize_ckpt.main(["--debug_tiny", "--device", "cpu",
                               "--ckpt", str(tmp_path / "fp.npz"),
                               "--out", str(tmp_path / "q.npz"), "--mode", mode])
    assert line.startswith(f"wrote {tmp_path / 'q.npz'} ({mode}; ")
    want = jq.quantize_model_params(_cast_bf16(p), mode=mode)
    got = jckpt.restore_checkpoint(str(tmp_path / "q.npz"), {"params": want})["params"]
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # and the serve CLI detects it and holds the w8a8 codes K-major
    model, _, server = serve.build(_args("--ckpt", str(tmp_path / "q.npz")))
    server.close()
    assert model.quant_mode == mode
    codes = [lp[n]["w_q8" if mode == "w8a8" else "w_q"] for tower in ("vilt", "bert")
             for lp in model[tower]["layers"] for n in ("mlp_in", "mlp_out")]
    assert all(is_k_major(c) == (mode == "w8a8") for c in codes)


def test_fp_checkpoint_is_cast_then_quantized(tmp_path):
    """An fp checkpoint with --quantize: the JAX script's order (restore,
    cast to bf16, quantize) gives the JAX package's leaves bit for bit."""
    _, p = _jax_params(3)
    jckpt.save_checkpoint(str(tmp_path / "fp"), {"params": p})
    from vault_tpu_torch.convert import params_from_jax

    model, _, server = serve.build(_args("--ckpt", str(tmp_path / "fp"), "--quantize", "w8a8"))
    server.close()
    want = params_from_jax(jax.tree.map(np.asarray, jq.quantize_model_params(
        _cast_bf16(p), mode="w8a8")), model.cfg)
    mine = model.state_dict()
    assert set(mine) == set(want)
    for k, t in want.items():
        assert mine[k].dtype == t.dtype and torch.equal(mine[k], t), k
    model, _, server = serve.build(_args("--ckpt", str(tmp_path / "fp")))
    server.close()
    assert model.quant_mode is None and model.use_pallas == "auto"
    assert all(t.dtype == torch.bfloat16 for t in model.state_dict().values())


def test_refusals_and_conflicts_exit_2(tmp_path, capsys):
    refused = ["--n_classes", "3129", "--quantize", "w8a8", "--merge_to", "8"]
    with pytest.raises(SystemExit) as e:
        serve.build(_args(*refused))
    assert e.value.code == 2 and "REFUSING" in capsys.readouterr().err
    model, _, server = serve.build(_args(*refused, "--force"))  # forced: served
    server.close()
    assert model.quant_mode == "w8a8" and model.merge_to == 8
    assert "WARNING (forced)" in capsys.readouterr().err
    with pytest.raises(SystemExit) as e:
        _args("--int8", "--quantize", "w8a8")
    assert e.value.code == 2 and "conflicts" in capsys.readouterr().err
    _, p = _jax_params(0)
    jckpt.save_checkpoint(str(tmp_path / "q"), {"params": jq.quantize_model_params(
        _cast_bf16(p), mode="w8a8")})
    with pytest.raises(SystemExit) as e:
        serve.build(_args("--ckpt", str(tmp_path / "q"), "--int8"))
    assert e.value.code == 2 and "stores w8a8" in capsys.readouterr().err


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = serve.parse_args(["--debug_tiny"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build(args)


def test_quantize_default_device_is_the_card(monkeypatch, tmp_path):
    """quantize_ckpt runs on the card unless asked for the CPU: without one
    it raises before it reads the checkpoint."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--debug_tiny", "--ckpt", str(tmp_path / "absent.npz"),
            "--out", str(tmp_path / "q.npz")]
    assert quantize_ckpt.parse_args(argv).device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quantize_ckpt.main(argv)
    assert not (tmp_path / "q.npz").exists()


def test_checkpoint_directories_are_served(tmp_path):
    """Without --ckpt the backbone comes from the checkpoint directories and
    the tokenizer from the language tower's (a BERTweet fastBPE layout)."""
    from vault_tpu_torch.cli import model_config
    from vault_tpu_torch.config import tiny_text_config
    from vault_tpu_torch.models import bert as tbert
    from vault_tpu_torch.models import vilt as tvilt
    from vault_tpu_torch.models.convert import bert_params_to_torch, vilt_params_to_torch
    from vault_tpu_torch.models.pretrained import save_safetensors
    from vault_tpu_torch.text.fastbpe import FastBPE

    cfg = model_config(_args())
    tower = tiny_text_config(vocab_size=99, type_vocab_size=1, pad_token_id=1,
                             position_embedding_style="roberta", max_position_embeddings=66)
    gen = torch.Generator().manual_seed(4)
    vilt_sd = tvilt.init_vilt(gen, cfg.vilt).state_dict()
    bert_sd = tbert.init_bert(gen, tower).state_dict()
    vd, bd = tmp_path / "vilt", tmp_path / "bertweet"
    vd.mkdir(), bd.mkdir()
    save_safetensors(vilt_params_to_torch(vilt_sd, cfg.vilt, "vilt."), str(vd / "model.safetensors"))
    save_safetensors({k: v.bfloat16() for k, v in bert_params_to_torch(
        bert_sd, tower, "roberta.").items()}, str(bd / "model.safetensors"))
    vc = {k: getattr(cfg.vilt, k) for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                             "num_attention_heads", "intermediate_size",
                                             "max_position_embeddings", "image_size",
                                             "patch_size")}
    (vd / "config.json").write_text(json.dumps(vc))
    bc = {k: getattr(tower, k) for k in ("vocab_size", "hidden_size", "num_hidden_layers",
                                          "num_attention_heads", "intermediate_size",
                                          "max_position_embeddings", "type_vocab_size",
                                          "pad_token_id")}
    (bd / "config.json").write_text(json.dumps(dict(bc, model_type="roberta")))
    (bd / "vocab.txt").write_text("".join(f"{w} 1\n" for w in ["the", "cat", "dog", "a"]))
    (bd / "bpe.codes").write_text("c a 1\nca t</w> 1\n")
    model, processor, server = serve.build(serve.parse_args([
        "--vilt", str(vd), "--bert", str(bd), "--device", "cpu", "--port", "0",
        "--canvas", "64x64", "--max_batch", "2"]))
    server.close()
    assert isinstance(processor.tokenizer, FastBPE)
    assert model.cfg.text_tower.position_embedding_style == "roberta"
    sd = model.state_dict()
    assert torch.equal(sd["bert.layers.1.mlp_in.w"].float(),
                       bert_sd["layers.1.mlp_in.w"].bfloat16().float())
    assert torch.equal(sd["vilt.layers.0.q.w"], vilt_sd["layers.0.q.w"].bfloat16())
    with torch.inference_mode():
        out = model(_batch(processor))
    assert out.shape == (3, 3) and torch.isfinite(out.float()).all()


def test_serve_cli_subprocess_answers(tmp_path):
    """``python -m vault_tpu_torch.cli.serve`` end to end, as
    tests/test_serving.py runs the JAX script: a pre-quantized (w8a8)
    checkpoint from the port's quantize CLI, merged to 8 patch tokens,
    /predict, /healthz and /metrics over HTTP."""
    from vault_tpu_torch.config import debug_tiny_vault_config
    from vault_tpu_torch.convert import params_to_jax
    from vault_tpu_torch.models.vault import VaultForClassification
    from vault_tpu_torch.training.checkpoint import save_checkpoint

    model = VaultForClassification(debug_tiny_vault_config(), device="cpu", seed=2)
    save_checkpoint(str(tmp_path / "fp"), {"params": params_to_jax(model.state_dict(),
                                                                   as_numpy=False)})
    quantize_ckpt.main(["--debug_tiny", "--device", "cpu", "--ckpt", str(tmp_path / "fp.npz"),
                        "--out", str(tmp_path / "q.npz")])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "vault_tpu_torch.cli.serve", "--debug_tiny", "--device", "cpu",
         "--ckpt", str(tmp_path / "q.npz"), "--port", str(port), "--max_batch", "2",
         "--max_wait_ms", "1", "--merge_to", "8"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    base = f"http://127.0.0.1:{port}"
    try:
        deadline, health = time.time() + 240, None
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"serve exited {proc.returncode}:\n"
                                     f"{proc.stdout.read()[-3000:]}")
            try:
                with urllib.request.urlopen(f"{base}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except (urllib.error.URLError, ConnectionError, OSError):
                time.sleep(0.5)
        assert health is not None and health["ok"], "server never came up"
        buf = io.BytesIO()
        Image.fromarray(np.random.default_rng(0).integers(0, 256, (48, 80, 3),
                                                          dtype=np.uint8)).save(buf, "PNG")
        req = urllib.request.Request(f"{base}/predict", data=json.dumps({
            "text": "a cat on the couch",
            "image_b64": base64.b64encode(buf.getvalue()).decode()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            body = json.loads(r.read())
        assert len(body["output"]) == 3 and all(np.isfinite(body["output"]))
        with urllib.request.urlopen(f"{base}/metrics", timeout=10) as r:
            assert r.headers["Content-Type"].startswith("text/plain")
            text = r.read().decode()
        served = [l for l in text.splitlines() if l.startswith("vault_requests_served ")]
        assert served and float(served[0].split()[1]) >= 2  # the warm-up and ours
        bad = urllib.request.Request(f"{base}/predict", data=b"{}",
                                     headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(bad, timeout=10)
        assert e.value.code == 400
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)



def test_hygiene_covers_the_serving_modules():
    """tests/test_torch_hygiene.py's import checks reach every module of
    this slice (it walks the package): the CLIs, the tokenizers, the
    checkpoint loaders and the export."""
    from tests import test_torch_hygiene as hygiene

    names = {"vault_tpu_torch.cli", "vault_tpu_torch.cli.serve",
             "vault_tpu_torch.cli.quantize_ckpt", "vault_tpu_torch.text.bpe",
             "vault_tpu_torch.text.fastbpe", "vault_tpu_torch.text.roberta_format",
             "vault_tpu_torch.models.pretrained", "vault_tpu_torch.models.convert",
             "vault_tpu_torch.export"}
    assert names <= set(hygiene._port_modules())
    files = {str(p.relative_to(hygiene.ROOT)) for p in hygiene.PORT_FILES}
    assert {n.replace(".", "/") + ".py" for n in names - {"vault_tpu_torch.cli"}} <= files
    assert "vault_tpu_torch/cli/__init__.py" in files


# ---------------------------------------------------------------------------
# The experiment CLI, ``python -m vault_tpu_torch.cli.clsf_vault``, against
# ``experiments/clsf_vault.py`` in process: the same synthetic data (solid
# colours, so both packages' resizes give the same pixels), ``--debug_tiny``
# without a text tower and every dropout at 0, and the same weights, a
# JAX-written checkpoint both load with ``--model_load_filename``.  The
# metrics both write: losses within fp32 atol 1e-5 / bf16 atol 2e-2 (as
# tests/test_torch_task_trainers.py), the discrete metrics equal.
# ---------------------------------------------------------------------------

def _make_bloomberg(root, n=24):
    d = root / "bloomberg"
    (d / "Twitter_images").mkdir(parents=True)
    with open(d / "bloomberg-textimage.csv", "w") as f:
        f.write("tweet_id,tweet,other,text_is_represented,image_adds\n")
        for i in range(n):
            f.write(f"{i},tweet number {i} #mynewcar,x,{i % 2},{(i // 2) % 2}\n")
    for i in range(n):
        Image.new("RGB", (60, 50), (i * 10 % 255, 40, 90)).save(
            d / "Twitter_images" / f"T{i}.jpg")
    return str(d)


def _make_mvsa(root, n=20):
    d = root / "MVSA_Single"
    (d / "data").mkdir(parents=True)
    kinds = ["positive", "neutral", "negative"]
    with open(d / "labelResultAll.txt", "w") as f:
        f.write("ID\ttext,image\n")
        for i in range(1, n + 1):
            f.write(f"{i}\t{kinds[i % 3]},{kinds[(i // 3) % 3]}\n")
    for i in range(1, n + 1):
        (d / "data" / f"{i}.txt").write_text(f"tweet {i} @user http://t.co/{i} 😀")
        Image.new("RGB", (50, 40 + i), (i * 12 % 255, 70, 20)).save(d / "data" / f"{i}.jpg")
    return str(d)


def _jax_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_clsf_vault", os.path.join(REPO, "experiments", "clsf_vault.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _metrics(root, exp):
    import yaml

    (run,) = os.listdir(os.path.join(root, exp))
    with open(os.path.join(root, exp, run, "metrics.yml")) as f:
        return run, yaml.safe_load(f)["experiment_0"]


CLSF_CASES = {
    "Bloomberg": (_make_bloomberg, ["--dev_size", "4", "--test_size", "4",
                                    "--tasks", "text_is_represented", "image_adds",
                                    "--val_split", "dev", "--test_split", "test"], 2,
                  "VaultTMSCBloomberg"),
    "MVSA": (_make_mvsa, ["--train_split", "train", "--val_split", "dev",
                          "--test_split", "test"], 6, "VaultTMSCMVSA"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", list(CLSF_CASES))
def test_clsf_vault_matches_the_jax_cli(tmp_path, monkeypatch, task, dtype):
    """MVSA (dual heads, ``--preprocessed`` off) and Bloomberg (two label
    columns, multi-label BCE): one epoch of 4-example batches with a dev
    evaluation after each step (a fresh loss window each, so the JAX
    trainer compiles its step once) and a test evaluation; the run
    directories and every metric."""
    from vault_tpu.config import VaultConfig as JVaultConfig
    from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
    from vault_tpu_torch.cli import clsf_vault

    make, extra, n_out, exp = CLSF_CASES[task]
    root = make(tmp_path)
    jcfg = JVaultConfig(vilt=j_tiny_vilt(image_size=64, patch_size=16, num_patch_tokens=16,
                                         vocab_size=30522))
    p = jvault.init_vault(jax.random.PRNGKey(4), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(5), 32, n_out)
    jckpt.save_checkpoint(str(tmp_path / "init"), jax.tree.map(np.asarray, p))
    argv = [task, "--root_dir", root, *extra, "--debug_tiny", "--vilt_dropout_prob", "0",
            "--model_load_filename", str(tmp_path / "init"), "--num_train_epochs", "1",
            "--train_batch_size", "4", "--eval_batch_size", "4", "--lr", "1e-3",
            "--compute_dtype", dtype, "--opt_state_dtype", "float32", "--disable_tqdm",
            "--device", "cpu", "--eval_steps", "1"]
    monkeypatch.setattr(sys, "argv", ["clsf_vault.py", *argv, "--experiment_root",
                                      str(tmp_path / "jax")])
    _jax_cli().main()
    (trainer,) = clsf_vault.main(argv + ["--experiment_root", str(tmp_path / "torch")])
    run_ref, ref = _metrics(str(tmp_path / "jax"), exp)
    run, ours = _metrics(str(tmp_path / "torch"), exp)
    assert run == run_ref
    assert ours.keys() == ref.keys() and "test_eval_loss" in ref
    assert trainer.args.early_stopping_metric == "eval_loss"
    for k, v in ref.items():
        if "loss" in k:
            np.testing.assert_allclose(ours[k], v, atol={"float32": 1e-5,
                                                         "bfloat16": 2e-2}[dtype], err_msg=k)
        elif k == "train_pairs_per_sec":  # a wall-clock rate, not a result
            assert ours[k] > 0, k
        else:
            assert ours[k] == v, k
    assert os.path.exists(os.path.join(str(tmp_path / "torch"), exp, run,
                                       "aggregated_metrics.yml"))


def test_clsf_vault_twitter_runs_with_a_text_tower(tmp_path):
    """Twitter201X with the bert tower and the placeholder token (the
    tokenizer grows by one entry; the word table, already wider, keeps its
    rows, as in the JAX script), on the host."""
    from vault_tpu_torch.cli import clsf_vault

    d, imgs = tmp_path / "twitter2015", tmp_path / "twitter2015_images"
    d.mkdir()
    imgs.mkdir()
    for split in ("train", "dev"):
        with open(d / f"{split}.tsv", "w") as f:
            f.write("index\t#1 Label\t#2 ImageID\t#3 String\t#3 String\n")
            for i in range(8):
                f.write(f"{i}\t{i % 3 - 1}\tim{i % 2}.jpg\ttweet {i} about $T$\ttarget {i}\n")
    for i in range(2):
        Image.new("RGB", (80, 60), (i * 40, 100, 150)).save(imgs / f"im{i}.jpg")
    (trainer,) = clsf_vault.main([
        "Twitter201X", "--dir", str(d), "--train_split", "train", "--dev_split", "dev",
        "--test_split", "dev", "--bert_model_name_or_path", "bert-base-uncased",
        "--debug_tiny", "--num_train_epochs", "1", "--train_batch_size", "4",
        "--add_placeholder_token", "--device", "cpu", "--disable_tqdm",
        "--experiment_root", str(tmp_path / "logs")])
    assert trainer.params["bert.embeddings.word"].shape[0] == 30522
    assert "test_eval_accuracy" in trainer.exp_handler._finals
    assert os.path.exists(os.path.join(trainer.exp_handler.directory(),
                                       "aggregated_metrics.yml"))


def test_clsf_vault_device_and_unported_flags(tmp_path, monkeypatch):
    """The card by default (raising without one); the mesh flags are ported:
    more data ranks than the (absent) group raises with no fallback, a
    coordinator without the process count raises, and ``--zero_opt`` with
    ``--coordinator_address`` trains on the group it joins (one gloo rank
    here, torch.distributed initialized and torn down)."""
    import torch.distributed as dist

    from vault_tpu_torch.cli import clsf_vault
    from vault_tpu_torch.parallel.multihost import free_port

    root = _make_mvsa(tmp_path, n=6)
    base = ["MVSA", "--root_dir", root, "--debug_tiny", "--num_train_epochs", "1",
            "--disable_tqdm", "--experiment_root", str(tmp_path / "logs")]
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        clsf_vault.main(base + ["--num_data_shards", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="num_processes"):
        clsf_vault.main(base + ["--coordinator_address", "localhost:1", "--device", "cpu"])
    try:
        (trainer,) = clsf_vault.main(base + [
            "--zero_opt", "--coordinator_address", f"localhost:{free_port()}",
            "--num_processes", "1", "--process_id", "0", "--device", "cpu"])
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        assert trainer.args.zero_opt and trainer.dp == 1
        assert trainer.opt_state.count > 0 and trainer.exp_handler._series["train_loss"]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        clsf_vault.main(base)


def test_clsf_vault_entity_cache_matches_the_jax_cli(tmp_path, monkeypatch):
    """Twitter201X with ``--entity_cache`` (and ``--add_placeholder_token``):
    two targets linked with descriptions and one without, so two entity
    tokens and ``$T$`` grow the tokenizer, the two entity rows ViLT's word
    table (no text tower; the minimal tokenizer's ``$T$`` id lies inside
    the table already), and the linked targets carry their tokens.  The weights are a
    JAX-written checkpoint of the grown table (the max-pooled rows are held
    in tests/test_torch_entity_linking.py); solid-colour images.  The run
    directories and every metric as for the other tasks."""
    import json

    from vault_tpu.config import VaultConfig as JVaultConfig
    from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
    from vault_tpu_torch.cli import clsf_vault

    d, imgs = tmp_path / "twitter2015", tmp_path / "twitter2015_images"
    d.mkdir()
    imgs.mkdir()
    for split, n in (("train", 8), ("dev", 4), ("test", 4)):
        with open(d / f"{split}.tsv", "w") as f:
            f.write("index\t#1 Label\t#2 ImageID\t#3 String\t#3 String\n")
            for i in range(n):
                f.write(f"{i}\t{i % 3 - 1}\tim{i % 2}.jpg\ttweet {i} about $T$\t"
                        f"target {i % 3}\n")
    for i in range(2):
        Image.new("RGB", (80, 60), (i * 40, 100, 150)).save(imgs / f"im{i}.jpg")
    cache = tmp_path / "entities.json"
    cache.write_text(json.dumps({"target 0": ["Zero", "a zero of the cat"],
                                 "target 1": ["One", "the one blue dog"],
                                 "target 2": ["Two", None]}))
    jcfg = JVaultConfig(vilt=j_tiny_vilt(image_size=64, patch_size=16, num_patch_tokens=16,
                                         vocab_size=30522 + 2))
    p = jvault.init_vault(jax.random.PRNGKey(4), jcfg)
    p["head"] = jvault.init_classifier_head(jax.random.PRNGKey(5), 32, 3)
    jckpt.save_checkpoint(str(tmp_path / "init"), jax.tree.map(np.asarray, p))
    argv = ["Twitter201X", "--dir", str(d), "--train_split", "train", "--dev_split", "dev",
            "--test_split", "test", "--entity_cache", str(cache), "--add_placeholder_token",
            "--debug_tiny", "--vilt_dropout_prob", "0", "--model_load_filename",
            str(tmp_path / "init"), "--num_train_epochs", "1", "--train_batch_size", "4",
            "--eval_batch_size", "4", "--lr", "1e-3", "--compute_dtype", "float32",
            "--opt_state_dtype", "float32", "--disable_tqdm", "--device", "cpu",
            "--eval_steps", "1"]
    monkeypatch.setattr(sys, "argv", ["clsf_vault.py", *argv, "--experiment_root",
                                      str(tmp_path / "jax")])
    _jax_cli().main()
    (trainer,) = clsf_vault.main(argv + ["--experiment_root", str(tmp_path / "torch")])
    run_ref, ref = _metrics(str(tmp_path / "jax"), "VaultTMSCTwitter201X")
    run, ours = _metrics(str(tmp_path / "torch"), "VaultTMSCTwitter201X")
    assert run == run_ref
    assert ours.keys() == ref.keys() and "test_eval_loss" in ref
    for k, v in ref.items():
        if "loss" in k:
            np.testing.assert_allclose(ours[k], v, atol=1e-5, err_msg=k)
        elif k == "train_pairs_per_sec":
            assert ours[k] > 0, k
        else:
            assert ours[k] == v, k
    assert trainer.params["vilt.text_embeddings.word"].shape[0] == 30522 + 2
    texts = trainer.train_dataset.texts
    assert texts[0].endswith("target 0/[Zero]") and texts[2].endswith("target 2")


# ---------------------------------------------------------------------------
# The baselines' CLI, ``python -m vault_tpu_torch.cli.tmsc_tombert``, against
# ``experiments/tmsc_tombert.py`` in process: a Twitter-2015 layout with
# noise images (the two packages' resizes agree within 1.1e-6 after the
# normalization, tests/test_torch_datasets.py), ``--debug_tiny`` (ResNet-18,
# a 64-pixel crop), the same weights in both (a JAX-written checkpoint
# through ``--model_load_filename``, its ResNet the torchvision-layout
# ``--resnet_weights`` file both packages cache the region embeddings
# from), and every dropout at 0 (the tiny text config's 0.1 patched to 0 in
# both packages; ``--vilt_dropout_prob 0``), so the two runs draw nothing.
# The metrics as for clsf_vault: losses fp32 atol 1e-5, the rest equal.
# ---------------------------------------------------------------------------

def _make_twitter(root, n_train=8, n_eval=4, seed=0):
    rng = np.random.default_rng(seed)
    d, imgs = root / "twitter2015", root / "twitter2015_images"
    d.mkdir()
    imgs.mkdir()
    words = "a the cat dog red blue sits on big small".split()
    for split, n in (("train", n_train), ("dev", n_eval), ("test", n_eval)):
        with open(d / f"{split}.tsv", "w") as f:
            f.write("index\t#1 Label\t#2 ImageID\t#3 String\t#3 String\n")
            for i in range(n):
                tweet = " ".join(rng.choice(words, 6))
                f.write(f"{i}\t{i % 3 - 1}\tim{i % 3}.jpg\t{tweet} $T$ {rng.choice(words)}"
                        f"\ttarget {words[i % len(words)]}\n")
    for i, hw in enumerate(((50, 70), (80, 45), (64, 64))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), dtype=np.uint8)).save(
            imgs / f"im{i}.jpg", format="PNG")  # lossless: both decode the same pixels
    return d


def _torchvision_resnet18(path, seed=0):
    """A torchvision-layout ResNet-18 state dict with moved BatchNorm
    statistics, saved with ``torch.save``."""
    from tests.test_tom_models import _torch_resnet

    torch.manual_seed(seed)
    sd = _torch_resnet(18).state_dict()
    g = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(0.1 * torch.randn(v.shape, generator=g))
        elif k.endswith("running_var"):
            v.copy_(0.5 + torch.rand(v.shape, generator=g))
    torch.save(sd, path)
    return sd


def _no_text_dropout(monkeypatch):
    import vault_tpu.config as jconfig
    import vault_tpu_torch.config as tconfig

    for mod in (jconfig, tconfig):
        base = mod.tiny_text_config
        monkeypatch.setattr(mod, "tiny_text_config", lambda _b=base, **kw: _b(
            **{**kw, "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}))


def _jax_tombert_cli():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "jax_tmsc_tombert", os.path.join(REPO, "experiments", "tmsc_tombert.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


TMSC_CASES = {"TomBERT": ["--pooling", "both"], "TomViLT": ["--use_tweet_bert"],
              "TomViLT_vilt_only": []}


@pytest.mark.parametrize("case", list(TMSC_CASES))
def test_tmsc_tombert_matches_the_jax_cli(tmp_path, monkeypatch, case):
    """One epoch of 4-example batches with a dev evaluation after each step
    and a test evaluation, TomBERT (pooling "both") and TomViLT with and
    without the tweet tower: the run directories and every metric; the
    region cache computed once per split."""
    from vault_tpu.config import VaultConfig as JVaultConfig
    from vault_tpu.config import tiny_text_config as j_tiny_text
    from vault_tpu.config import tiny_vilt_config as j_tiny_vilt
    from vault_tpu.models import tombert as jtombert
    from vault_tpu.models import tomvilt as jtomvilt
    from vault_tpu.models.resnet import resnet_params_from_torch as j_resnet_from_torch
    from vault_tpu_torch.cli import tmsc_tombert

    _no_text_dropout(monkeypatch)
    model = case.split("_")[0]
    d = _make_twitter(tmp_path)
    sd = _torchvision_resnet18(tmp_path / "r18.pth")
    text = j_tiny_text(vocab_size=30522, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0)
    key = jax.random.PRNGKey(4)
    if model == "TomBERT":
        p = jtombert.init_tombert(key, text, 3, "both", 512, 1, resnet_depth=18)
    else:
        vcfg = JVaultConfig(vilt=j_tiny_vilt(vocab_size=30522),
                            text_tower=text if "--use_tweet_bert" in TMSC_CASES[case] else None)
        p = jtomvilt.init_tomvilt(key, vcfg, text, 3, 512, 1, resnet_depth=18)
    p["resnet"] = j_resnet_from_torch(sd, 18)
    jckpt.save_checkpoint(str(tmp_path / "init"), jax.tree.map(np.asarray, p))
    argv = [model, "--dir", str(d), "--train_split", "train", "--dev_split", "dev",
            "--test_split", "test", *TMSC_CASES[case], "--debug_tiny",
            "--resnet_weights", str(tmp_path / "r18.pth"), "--vilt_dropout_prob", "0",
            "--model_load_filename", str(tmp_path / "init"), "--num_train_epochs", "1",
            "--train_batch_size", "4", "--eval_batch_size", "4", "--lr", "1e-3",
            "--compute_dtype", "float32", "--opt_state_dtype", "float32",
            "--disable_tqdm", "--device", "cpu", "--eval_steps", "1"]
    monkeypatch.setattr(sys, "argv", ["tmsc_tombert.py", *argv, "--experiment_root",
                                      str(tmp_path / "jax")])
    _jax_tombert_cli().main()
    (trainer,) = tmsc_tombert.main(argv + ["--experiment_root", str(tmp_path / "torch")])
    exp = f"{model}TMSC"
    run_ref, ref = _metrics(str(tmp_path / "jax"), exp)
    run, ours = _metrics(str(tmp_path / "torch"), exp)
    assert run == run_ref
    assert ours.keys() == ref.keys() and "test_eval_loss" in ref
    for k, v in ref.items():
        if "loss" in k:
            np.testing.assert_allclose(ours[k], v, atol=1e-5, err_msg=k)
        elif k == "train_pairs_per_sec":
            assert ours[k] > 0, k
        else:
            assert ours[k] == v, k
    for ds in (trainer.train_dataset, trainer.dev_dataset, trainer.test_dataset):
        assert ds.embeddings.shape == (ds.num_examples, 4, 512)
        assert ds._emb_src is trainer.resnet_params


def test_tmsc_tombert_refusals(tmp_path, monkeypatch, capsys):
    """``--merge_to`` exits 2 (the JAX script's parser error), the mesh
    flags are ported (``--zero_opt`` and ``--num_data_shards`` reach the
    TrainArgs; more data ranks than the absent group raise at the trainer,
    with no fallback), and the card is the default device."""
    from vault_tpu_torch.cli import tmsc_tombert
    from vault_tpu_torch.cli.args import apply_device_arg, trainer_args_from_namespace
    from vault_tpu_torch.training.trainer import Trainer

    base = ["TomBERT", "--dir", str(tmp_path), "--train_split", "train", "--debug_tiny"]
    with pytest.raises(SystemExit) as e:
        tmsc_tombert.parse_args(base + ["--merge_to", "8"])
    assert e.value.code == 2 and "--merge_to" in capsys.readouterr().err
    args = tmsc_tombert.parse_args(base + ["--zero_opt", "--num_data_shards", "2",
                                           "--device", "cpu"])
    apply_device_arg(args)  # no coordinator: nothing to join
    targs = trainer_args_from_namespace(args)
    assert targs.zero_opt and targs.num_data_shards == 2
    with pytest.raises(RuntimeError, match="initialized torch.distributed"):
        Trainer(None, {}, targs, None, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmsc_tombert.main(base)


@pytest.mark.parametrize("flags,match", [
    (["--dp", "3", "--max_batch", "8"], "--max_batch 8 must divide by --dp 3"),
    (["--pp", "--tp", "2"], "--pp is mutually exclusive"),
    (["--pp", "--dp", "2"], "--pp is mutually exclusive"),
    (["--pp", "--merge_to", "8"], "--merge_to is not supported with --pp")])
def test_serve_parallel_flag_checks(flags, match, capsys):
    """The JAX script's checks of --dp, --tp and --pp: each exits 2."""
    with pytest.raises(SystemExit) as e:
        serve.parse_args(["--debug_tiny", "--device", "cpu", *flags])
    assert e.value.code == 2 and match in capsys.readouterr().err


@pytest.mark.parametrize("flags", [["--dp", "2"], ["--tp", "2"], ["--dp", "2", "--tp", "2"],
                                   ["--pp"], ["--tp", "2", "--quantize", "w8a8"]])
def test_serve_parallel_forward_matches_the_model(flags, monkeypatch):
    """``cli.serve.build`` with --dp/--tp/--pp on the host (named once per
    shard): the served callable's rows equal the model's direct forward
    (DP exactly; TP and the pipeline within the file's bf16 tolerances:
    the row products are summed in another order, and the w8a8 direct
    forward runs the fused blocks' plain versions, which round at the
    kernels' points).  On the card, more devices than are visible
    raise."""
    from vault_tpu_torch.serving import pad_rows

    model, processor, server = serve.build(_args(*flags))
    server.close()
    enc = {k: pad_rows(v, 4) for k, v in _batch(processor).items()}
    with torch.inference_mode():
        direct = model(enc).float()
        served = server.engine.apply(enc).float()
    if flags == ["--dp", "2"]:
        assert torch.equal(served, direct)
    else:
        np.testing.assert_allclose(served.numpy(), direct.numpy(), atol=ATOL, rtol=RTOL)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="asks for 2 devices; 1 card"):
        serve.serving_devices("cuda", 2)
