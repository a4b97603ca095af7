"""Shared RoBERTa-format sequence assembly: <s> A </s> [</s> B </s>] (a copy
of the JAX package's ``vault_tpu/text/roberta_format.py``).

Mixin over any tokenizer exposing ``tokenize``, ``convert_tokens_to_ids``,
``vocab``, ``bos_token``/``eos_token`` and ``pad_token_id`` — used by both
the byte-level BPE (text/bpe.py, RobertaTokenizer lineage) and the BERTweet
fastBPE (text/fastbpe.py), whose encode paths are identical by construction
(both are RoBERTa-architecture towers; token_type_ids are all zero)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence


class RobertaEncodeMixin:
    def encode(self, text: str, text_pair: Optional[str] = None,
               max_length: Optional[int] = None, padding: str = "max_length",
               truncation: bool = True) -> Dict[str, List[int]]:
        """RoBERTa format: <s> A </s> [</s> B </s>]; token_type_ids all 0;
        longest-first truncation for pairs (HF semantics)."""
        a = self.convert_tokens_to_ids(self.tokenize(text))
        b = (self.convert_tokens_to_ids(self.tokenize(text_pair))
             if text_pair is not None else None)
        n_special = 4 if b is not None else 2
        if truncation and max_length is not None:
            budget = max_length - n_special
            if b is None:
                a = a[:budget]
            else:
                while len(a) + len(b) > budget:
                    if len(a) >= len(b):
                        a = a[:-1]
                    else:
                        b = b[:-1]
        bos, eos = self.vocab[self.bos_token], self.vocab[self.eos_token]
        ids = [bos] + a + [eos]
        if b is not None:
            ids += [eos] + b + [eos]
        mask = [1] * len(ids)
        type_ids = [0] * len(ids)
        if padding == "max_length" and max_length is not None:
            pad_n = max_length - len(ids)
            ids += [self.pad_token_id] * pad_n
            mask += [0] * pad_n
            type_ids += [0] * pad_n
        return {"input_ids": ids, "attention_mask": mask,
                "token_type_ids": type_ids}

    def batch_encode(self, texts: Sequence[str],
                     text_pairs: Optional[Sequence[Optional[str]]] = None,
                     max_length: Optional[int] = None,
                     padding: str = "max_length", truncation: bool = True):
        import numpy as np

        if text_pairs is None:
            text_pairs = [None] * len(texts)
        encs = [self.encode(t, p, max_length, padding, truncation)
                for t, p in zip(texts, text_pairs)]
        if padding != "max_length" or max_length is None:
            max_len = max(len(e["input_ids"]) for e in encs)
            for e in encs:
                pad_n = max_len - len(e["input_ids"])
                e["input_ids"] += [self.pad_token_id] * pad_n
                e["attention_mask"] += [0] * pad_n
                e["token_type_ids"] += [0] * pad_n
        return {k: np.asarray([e[k] for e in encs], np.int32)
                for k in ("input_ids", "attention_mask", "token_type_ids")}
