"""Data pipeline: synthetic corpus → MatRel relational preprocessing →
packed training batches with background prefetch.

This is where the paper's engine feeds the trainer: the raw token matrix
is cleaned with a relational selection (σ_rows≠NULL drops empty
documents) and split with RID-range selections (k-fold cross-validation,
paper §3.2), through the port's ``Session`` on the session's device. The
same seed gives the JAX package's corpus, train and holdout matrices and
batches.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import Session
from repro_torch.device import resolve_device


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_docs: int = 512
    doc_len: int = 2048
    seed: int = 0
    empty_doc_fraction: float = 0.05   # exercised by σ_rows≠NULL cleaning
    holdout_fold: int = 0              # k-fold split via RID-range selects
    n_folds: int = 10


class SyntheticCorpus:
    """Zipf-distributed synthetic documents as a (docs × doc_len) matrix;
    the relational steps run on ``device`` (``None`` → the card)."""

    def __init__(self, dc: DataConfig, device=None):
        rng = np.random.default_rng(dc.seed)
        z = rng.zipf(1.3, size=(dc.n_docs, dc.doc_len))
        toks = 1 + (z % (dc.vocab_size - 1))
        empty = rng.uniform(size=dc.n_docs) < dc.empty_doc_fraction
        toks[empty] = 0
        self.matrix = toks.astype(np.float32)
        self.dc = dc
        self.device = resolve_device(device)

    def _session(self) -> Session:
        return Session(block_size=256, device=self.device)

    def _cleaned(self) -> np.ndarray:
        return self._session().load(self.matrix, "corpus").select(
            "rows != NULL").to_numpy()                  # drop empty docs

    def preprocess(self) -> np.ndarray:
        """MatRel relational cleaning + split (returns the train matrix)."""
        dc = self.dc
        cleaned_np = self._cleaned()
        n = cleaned_np.shape[0]
        fold = n // dc.n_folds
        lo, hi = dc.holdout_fold * fold, (dc.holdout_fold + 1) * fold - 1
        c = self._session().load(cleaned_np, "cleaned")
        empty = np.zeros((0, cleaned_np.shape[1]), np.float32)
        head = c.select(f"RID>=0 AND RID<={lo - 1}").to_numpy() \
            if lo > 0 else empty
        tail = c.select(f"RID>={hi + 1} AND RID<={n - 1}").to_numpy() \
            if hi + 1 <= n - 1 else empty
        return np.concatenate([head, tail], axis=0)

    def holdout(self) -> np.ndarray:
        dc = self.dc
        cleaned = self._cleaned()
        fold = cleaned.shape[0] // dc.n_folds
        lo = dc.holdout_fold * fold
        m = self._session().load(cleaned, "c2")
        return m.select(f"RID>={lo} AND RID<={lo + fold - 1}").to_numpy()


def pack_batches(tokens_matrix: np.ndarray, dc: DataConfig,
                 drop_remainder: bool = True) -> Iterator[Dict[str, np.ndarray]]:
    """Pack documents into (B, S+1) streams → {tokens, labels} batches."""
    flat = tokens_matrix.reshape(-1).astype(np.int64)
    flat = flat[flat != 0]
    span = dc.seq_len + 1
    per_batch = dc.global_batch * span
    n_batches = len(flat) // per_batch
    for i in range(max(1, n_batches)):
        chunk = flat[i * per_batch: (i + 1) * per_batch]
        if len(chunk) < per_batch:
            chunk = np.pad(chunk, (0, per_batch - len(chunk)),
                           constant_values=1)
        arr = chunk.reshape(dc.global_batch, span)
        yield {"tokens": arr[:, :-1].astype(np.int32),
               "labels": arr[:, 1:].astype(np.int32)}


class PrefetchLoader:
    """Background-thread prefetch of host batches (depth-bounded queue)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._done = object()

        def work():
            for item in it:
                self.q.put(item)
            self.q.put(self._done)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is self._done:
                return
            yield item


def make_loader(cfg: ModelConfig, shape: ShapeConfig, n_docs: int = 512,
                seed: int = 0, device=None) -> Iterator:
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=shape.seq_len,
                    global_batch=shape.global_batch, n_docs=n_docs,
                    seed=seed)
    corpus = SyntheticCorpus(dc, device)
    train = corpus.preprocess()
    return PrefetchLoader(pack_batches(train, dc))
