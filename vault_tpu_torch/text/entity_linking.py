"""Entity linking of TMSC targets (port of ``vault_tpu/text/entity_linking.py``).

The reference optionally runs REL (mention detection + entity
disambiguation) over TMSC targets, fetches each entity's first Wikipedia
paragraph, caches the results in a JSON file keyed by dir/split/wiki/threshold
(vault/tmsc_utils/dataset.py:185-283), and grows the tokenizer, each new
entity token's embedding the MAX-POOL of its description's token embeddings
(vault/entity_linking.py:115-148).

The REL linker is used when REL is importable; otherwise ``link`` raises
unless a JSON cache already holds the answers.  :class:`OfflineEntityLinker`
links from a local alias store.  The cache files are those of the JAX
package, so either package reads the other's.  The embedding tables are
tensors here (a state dict's); the max-pool runs in torch on the table's
rows.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

logger = logging.getLogger(__name__)


def entities_cache_filename(cache_dir: str, dataset_dir: str,
                            splits: Sequence[str], wiki_version: str,
                            threshold: float) -> str:
    """Cache file keyed by dataset dir/split/wiki/threshold (reference
    convention, vault/tmsc_utils/dataset.py:185-229)."""
    base = os.path.basename(os.path.normpath(dataset_dir))
    name = f"entities_{base}_{'-'.join(splits)}_{wiki_version}_{threshold}.json"
    return os.path.join(cache_dir, name)


def load_entity_cache(path: str) -> Optional[Dict[str, Tuple[Optional[str], Optional[str]]]]:
    """Load cached target -> (entity, description); corrupted files are
    detected and discarded (reference behavior)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            data = json.load(f)
        assert isinstance(data, dict)
        return {k: tuple(v) if v is not None else (None, None)
                for k, v in data.items()}
    except Exception:
        logger.warning("corrupted entity cache at %s; ignoring", path)
        return None


def save_entity_cache(path: str, cache: Dict):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({k: list(v) for k, v in cache.items()}, f)


class EntityLinker:
    """REL-backed target linker (vault/entity_linking.py:15-112).  Each
    target string maps to (entity_name, first_wikipedia_paragraph) or
    (None, None) below the confidence threshold."""

    def __init__(self, root_dir: str, wiki_version: str = "wiki_2019",
                 threshold: float = 10000.0):
        self.root_dir = root_dir
        self.wiki_version = wiki_version
        self.threshold = threshold
        try:
            from REL.mention_detection import MentionDetection  # noqa: F401

            self._available = True
        except ImportError:
            self._available = False

    @property
    def available(self) -> bool:
        return self._available

    def link(self, targets: Sequence[str]) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
        if not self._available:
            raise RuntimeError(
                "REL is not installed in this environment; provide a JSON "
                "entity cache instead (load_entity_cache)")
        from REL.entity_disambiguation import EntityDisambiguation
        from REL.mention_detection import MentionDetection
        from REL.ner import Cmns
        from REL.utils import process_results

        md = MentionDetection(self.root_dir, self.wiki_version)
        tagger = Cmns(self.root_dir, self.wiki_version, n=5)
        ed = EntityDisambiguation(self.root_dir, self.wiki_version,
                                  {"mode": "eval", "model_path": "ed-wiki-2019"})
        inputs = {t: [t, []] for t in targets}
        mentions, _ = md.find_mentions(inputs, tagger)
        preds, _ = ed.predict(mentions)
        results = process_results(mentions, preds, inputs)
        out: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
        for t in targets:
            spans = results.get(t, [])
            if not spans:
                out[t] = (None, None)
                continue
            # reference semantics (vault/entity_linking.py:88-92): the
            # entity is KEPT below threshold; only the description is
            # withheld — matching OfflineEntityLinker, so cache files from
            # either backend are interchangeable
            ent, conf = spans[0][3], spans[0][5]
            out[t] = (ent, self._describe(ent)
                      if conf >= self.threshold else None)
        return out

    def _describe(self, entity: str) -> Optional[str]:
        try:
            import wikipedia

            done = False
            while not done:
                try:
                    page = wikipedia.WikipediaPage(entity)
                    done = True
                except wikipedia.DisambiguationError as e:
                    entity = str(e).split("\n")[1]
            text = page.content
            return text[: text.find("\n")]
        except Exception:
            return None


class OfflineEntityLinker:
    """REL-shaped linker over a LOCAL alias-dictionary + description store —
    the no-egress backend closing the reference's online loop
    (vault/entity_linking.py:49-112: mention detection -> disambiguation ->
    threshold -> Wikipedia first paragraph with a DisambiguationError retry
    that follows the page's first suggestion).

    Store file (JSON)::

        {"aliases": {"<alias lowercase>": [["Entity_Name", score], ...]},
         "descriptions": {"Entity_Name": "first paragraph ..."},
         "disambiguations": {"Ambiguous_Entity": ["Concrete_Entity", ...]}}

    Mention detection is alias lookup on the normalized target; the
    best-scoring candidate is the disambiguation; candidates below
    ``threshold`` return ``(entity, None)`` exactly like the reference's
    confidence gate (entity kept, description withheld,
    vault/entity_linking.py:88-92); disambiguation-page entities follow
    their first suggestion, mirroring the ``str(e).split("\\n")[1]`` retry.
    """

    def __init__(self, store_path: str, threshold: float = 0.0):
        with open(store_path) as f:
            store = json.load(f)
        self.aliases: Dict[str, List] = store.get("aliases", {})
        self.descriptions: Dict[str, str] = store.get("descriptions", {})
        self.disambiguations: Dict[str, List[str]] = store.get(
            "disambiguations", {})
        self.threshold = threshold

    @staticmethod
    def _normalize(target: str) -> str:
        return " ".join(target.lower().split())

    def _describe(self, entity: str) -> Optional[str]:
        seen = set()
        while entity in self.disambiguations and entity not in seen:
            seen.add(entity)
            options = self.disambiguations[entity]
            if not options:
                return None
            entity = options[0]
        return self.descriptions.get(entity)

    def link(self, targets: Sequence[str]) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
        out: Dict[str, Tuple[Optional[str], Optional[str]]] = {}
        for t in targets:
            cands = self.aliases.get(self._normalize(t), [])
            if not cands:
                out[t] = (None, None)
                continue
            entity, score = max(cands, key=lambda c: c[1])
            if score < self.threshold:
                out[t] = (entity, None)
            else:
                out[t] = (entity, self._describe(entity))
        return out


def build_entity_cache(cache_path: str, targets: Sequence[str],
                       linker) -> Dict[str, Tuple[Optional[str], Optional[str]]]:
    """Run ``linker`` over unseen targets and persist the JSON cache — the
    reference dataset's link-then-cache flow (vault/tmsc_utils/dataset.py:
    185-283) keyed by target string."""
    cache = load_entity_cache(cache_path) or {}
    todo = [t for t in dict.fromkeys(targets) if t not in cache]
    if todo:
        cache.update(linker.link(todo))
        save_entity_cache(cache_path, cache)
    return cache


def integrate_entities_into_embeddings(word_embeddings: torch.Tensor,
                                       descriptions: List[str],
                                       tokenizer) -> torch.Tensor:
    """Grow the word-embedding table by len(descriptions) rows, each the
    per-dimension max over the description's token rows, the [CLS] and
    [SEP] rows included: the reference pools over ``tokenizer.encode(desc)``,
    special tokens and all (vault/entity_linking.py:115-148).
    ``descriptions`` are in the order the entity tokens were added (last
    added = last row).  A description with no known token gives a zero
    row.  Returns a new table in the given table's dtype and device."""
    n_new = len(descriptions)
    if n_new == 0:
        return word_embeddings
    n, dim = word_embeddings.shape
    new_rows = torch.zeros((n_new, dim), dtype=torch.float32,
                           device=word_embeddings.device)
    special_ids = []
    for attr in ("cls_token", "sep_token"):
        tok = getattr(tokenizer, attr, None)
        if tok:
            got = tokenizer.convert_tokens_to_ids([tok])
            special_ids.append(got[0] if isinstance(got, (list, tuple))
                               else got)
    for i, description in enumerate(descriptions):  # add order == row order
        ids = tokenizer.convert_tokens_to_ids(tokenizer.tokenize(description))
        ids = [j for j in list(ids) + special_ids if j < n]
        if ids:
            rows = word_embeddings.detach()[torch.as_tensor(ids)].float()
            new_rows[i] = rows.max(dim=0).values
    return torch.cat([word_embeddings.detach(), new_rows.to(word_embeddings.dtype)])


def resolve_entities_for_cli(entity_cache: Optional[str],
                             wiki_store: Optional[str], threshold: float,
                             tokenizer, read_targets):
    """Link-then-cache flow shared by both experiment CLIs (reference
    dataset flow, vault/tmsc_utils/dataset.py:185-283): build the JSON
    cache when missing (offline alias store, or REL when importable), load
    it, register "[entity]" tokens on the tokenizer, and return

      (entity_map: target -> "[entity]" token appended to the target text,
       entity_descriptions: descriptions in token-registration order —
       the order integrate_entities_into_embeddings appends rows in).

    ``read_targets`` is a zero-arg callable producing the targets to link
    (only invoked when the cache must be built)."""
    entity_map: Dict[str, str] = {}
    descriptions: list = []
    if wiki_store and not entity_cache:
        raise ValueError(
            "--wiki_store was given without --entity_cache: the store is "
            "only consulted when building the cache file — pass "
            "--entity_cache <path> to build/use one")
    if not entity_cache or not hasattr(tokenizer, "add_tokens"):
        return entity_map, descriptions

    if not os.path.exists(entity_cache):
        if wiki_store:
            linker = OfflineEntityLinker(wiki_store, threshold)
        else:
            rel = EntityLinker(".", threshold=threshold)
            linker = rel if rel.available else None
        if linker is None:
            # the reference raises from EntityLinker here; silently training
            # with ZERO entities would misreport the requested experiment
            raise RuntimeError(
                f"--entity_cache {entity_cache} does not exist and no linker "
                "is available to build it (REL is not importable and no "
                "--wiki_store was given). Provide an existing cache file or "
                "an offline alias store.")
        build_entity_cache(entity_cache, read_targets(), linker)

    cache = load_entity_cache(entity_cache) or {}
    for tgt, (entity, desc) in cache.items():
        if entity and desc:
            token = f"[{entity}]"  # reference token surface (:270)
            if tokenizer.add_tokens([token]) == 1:
                descriptions.append(desc)
            entity_map[tgt] = token
    return entity_map, descriptions


def integrate_entities_into_vault(params, cfg, entity_descriptions,
                                  tokenizer, prefix: str = ""):
    """Grow the active text tower's word table with the entity rows
    (:func:`integrate_entities_into_embeddings`) and the matching config
    vocab_size: the LM tower's when the config has one, else ViLT's.
    ``params``: a state dict holding a VAuLT model's keys under ``prefix``
    (``"vault."`` in a TomViLT tree).  Returns ``(params, cfg)``, new; the
    given dict is not changed."""
    import dataclasses

    if not entity_descriptions:
        return params, cfg
    bert = cfg.text_tower is not None
    key = prefix + ("bert.embeddings.word" if bert else "vilt.text_embeddings.word")
    table = integrate_entities_into_embeddings(params[key], entity_descriptions,
                                               tokenizer)
    params = {**params, key: table}
    if bert:
        cfg = dataclasses.replace(cfg, text_tower=dataclasses.replace(
            cfg.text_tower, vocab_size=int(table.shape[0])))
    else:
        cfg = dataclasses.replace(cfg, vilt=dataclasses.replace(
            cfg.vilt, vocab_size=int(table.shape[0])))
    return params, cfg
