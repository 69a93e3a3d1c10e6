"""The port's checkpoints, data pipeline and training launcher against the
JAX package's, on the CPU.

Checkpoints: round trip, keep-latest, corruption, the async save's host
copy, bf16 refused, and the one on-disk layout: a checkpoint written by
either package restores in the other bit for bit, with equal manifests.
Data: the corpus, the MatRel-cleaned train and holdout matrices and the
packed batches equal the JAX package's exactly (integers and float32
token ids: nothing is rounded). The launcher runs end to end in a
subprocess (the command of ``tests/test_system.py:60-69``, on the
CPU) and needs a card without ``--device``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.ckpt import Checkpointer as RefCheckpointer
from repro.configs import get_config as ref_get_config
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShapeConfig
from repro.data import pipeline as ref_pipe
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import pipeline as pipe
from repro_torch.launch import train as launch_train
from repro_torch.models import api as tapi
from repro_torch.models.module import init_params, tree_items, tree_map
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.step import TrainState, init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]


def _tree(rng):
    return {"params": {"w": rng.normal(size=(8, 8)).astype(np.float32),
                       "blk": {"b": rng.normal(size=(3,)).astype(np.float32)}},
            "opt": {"count": np.asarray(7, np.int32),
                    "m": rng.normal(size=(4, 2)).astype(np.float32)}}


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


# -- checkpoints --------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    tree = tree_map(torch.as_tensor, _tree(rng))
    ck = Checkpointer(str(tmp_path))
    ck.save(7, tree, blocking=True)
    like = tree_map(torch.zeros_like, tree)
    restored, step = ck.restore(like)
    assert step == 7
    for (k, a), (_, b) in zip(tree_items(tree), tree_items(restored)):
        assert isinstance(b, np.ndarray)
        np.testing.assert_array_equal(a.numpy(), b, err_msg=str(k))
    on_cpu, _ = ck.restore(like, device="cpu")
    for (k, a), (_, b) in zip(tree_items(tree), tree_items(on_cpu)):
        assert b.device.type == "cpu" and b.dtype == a.dtype, k
        assert torch.equal(a, b), k


def test_checkpoint_keeps_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, {"w": torch.zeros(4) + s}, blocking=True)
    assert ck.available() == [3, 4]
    restored, step = ck.restore({"w": torch.zeros(4)})
    assert step == 4 and (restored["w"] == 4).all()


def test_checkpoint_detects_corruption(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(16)}, blocking=True)
    d = os.path.join(str(tmp_path), "step_00000001")
    fname = _manifest(str(tmp_path), 1)["leaves"]["w"]["file"]
    arr = np.load(os.path.join(d, fname))
    arr[0] = 999.0
    np.save(os.path.join(d, fname), arr)
    with pytest.raises(IOError, match="checksum"):
        ck.restore({"w": torch.zeros(16)})
    restored, _ = ck.restore({"w": torch.zeros(16)}, verify=False)
    assert restored["w"][0] == 999.0
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore({"w": torch.zeros(1)})


def test_save_copies_the_leaves_before_it_returns(tmp_path):
    ck = Checkpointer(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    ck.save(1, {"w": w})
    w.mul_(-1)           # the train step updates in place at once
    ck.wait()
    restored, _ = ck.restore({"w": w})
    np.testing.assert_array_equal(restored["w"],
                                  np.arange(1 << 16, dtype=np.float32))


def test_bf16_leaf_is_refused(tmp_path):
    ck = Checkpointer(str(tmp_path))
    with pytest.raises(TypeError, match="bfloat16"):
        ck.save(1, {"a": {"w": torch.ones(2, dtype=torch.bfloat16)}})
    assert ck.available() == []


def test_missing_leaf_raises(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": torch.ones(2)}, blocking=True)
    with pytest.raises(KeyError, match="missing leaf v"):
        ck.restore({"w": torch.ones(2), "v": torch.ones(2)})


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    tree = _tree(np.random.default_rng(1))
    RefCheckpointer(str(tmp_path / "ref")).save(
        5, jax.tree.map(jnp.asarray, tree), blocking=True)
    port_dir = str(tmp_path / "port")
    Checkpointer(port_dir).save(5, tree_map(torch.as_tensor, tree),
                                blocking=True)
    # one layout: the same keys in the same order, shapes, dtypes, crc32s
    # and file names (the key's hash, within one process)
    assert _manifest(str(tmp_path / "ref"), 5) == _manifest(port_dir, 5)
    like = tree_map(torch.as_tensor, tree)
    restored, step = Checkpointer(str(tmp_path / "ref")).restore(
        like, device="cpu")
    assert step == 5
    for (k, a), (_, b) in zip(tree_items(tree), tree_items(restored)):
        assert b.dtype == torch.as_tensor(a).dtype, k
        assert b.numpy().tobytes() == a.tobytes(), k


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    tree = _tree(np.random.default_rng(2))
    Checkpointer(str(tmp_path)).save(9, tree_map(torch.as_tensor, tree),
                                     blocking=True)
    like = jax.tree.map(np.zeros_like, tree)
    restored, step = RefCheckpointer(str(tmp_path)).restore(like)
    assert step == 9
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_train_state_restores_into_a_fresh_state(tmp_path):
    cfg = reduced(get_config("qwen3-1.7b"))
    params = init_params(tapi.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    batches = [{"tokens": torch.as_tensor(rng.integers(1, 512, (2, 16)),
                                          dtype=torch.int32),
                "labels": torch.as_tensor(rng.integers(1, 512, (2, 16)),
                                          dtype=torch.int32)}
               for _ in range(2)]
    live, _ = step(init_state(params, opt), batches[0])
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": live.params, "opt": live.opt._asdict()},
            blocking=True)
    fresh = init_params(tapi.spec(cfg), torch.Generator().manual_seed(1),
                        "cpu")
    like = {"params": fresh, "opt": init_state(fresh, opt).opt._asdict()}
    tree, _ = ck.restore(like, device="cpu")
    restored = TrainState(tree["params"], AdamWState(**tree["opt"]), None,
                          tree["opt"]["count"])
    live, m_live = step(live, batches[1])
    restored, m_restored = step(restored, batches[1])
    assert float(m_live["loss"]) == float(m_restored["loss"])
    for (k, a), (_, b) in zip(tree_items(live.params),
                              tree_items(restored.params)):
        assert torch.equal(a, b), k


# -- data pipeline ------------------------------------------------------------

DATA_CASES = [
    dict(vocab_size=512, seq_len=32, global_batch=4, n_docs=64, doc_len=64,
         empty_doc_fraction=0.2, seed=1),
    dict(vocab_size=512, seq_len=32, global_batch=4, n_docs=64, doc_len=64,
         seed=2, holdout_fold=1),
    dict(vocab_size=151_936, seq_len=64, global_batch=2, n_docs=300,
         doc_len=96, seed=0, holdout_fold=9),
]


@pytest.mark.parametrize("case", DATA_CASES)
def test_corpus_train_holdout_and_batches_match_reference(case):
    ref = ref_pipe.SyntheticCorpus(ref_pipe.DataConfig(**case))
    port = pipe.SyntheticCorpus(pipe.DataConfig(**case), device="cpu")
    np.testing.assert_array_equal(port.matrix, ref.matrix)
    want, got = ref.preprocess(), port.preprocess()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    hold = port.holdout()
    np.testing.assert_array_equal(hold, ref.holdout())
    # tests/test_ft_ckpt_data.py: empty docs and the holdout fold removed
    n_clean = int((port.matrix.sum(axis=1) != 0).sum())
    assert got.shape[0] == n_clean - n_clean // port.dc.n_folds
    assert (got.sum(axis=1) != 0).all()
    train_rows = {r.tobytes() for r in got}
    assert all(r.tobytes() not in train_rows for r in hold)
    want_b = list(ref_pipe.pack_batches(want, ref.dc))
    got_b = list(pipe.pack_batches(got, port.dc))
    assert len(got_b) == len(want_b)
    for g, w in zip(got_b, want_b):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])
        assert (g["tokens"][:, 1:] == g["labels"][:, :-1]).all()


def test_make_loader_matches_reference():
    ref = list(ref_pipe.make_loader(ref_reduced(ref_get_config("qwen3-1.7b")),
                                    RefShapeConfig("t", 32, 4, "train"),
                                    n_docs=64, seed=3))
    got = list(pipe.make_loader(reduced(get_config("qwen3-1.7b")),
                                ShapeConfig("t", 32, 4, "train"),
                                n_docs=64, seed=3, device="cpu"))
    assert len(got) == len(ref) > 1
    for g, w in zip(got, ref):
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_loader_yields_all():
    assert list(pipe.PrefetchLoader(iter(range(10)), depth=3)) == \
        list(range(10))


def test_corpus_without_a_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pipe.SyntheticCorpus(pipe.DataConfig(512, 32, 4, n_docs=8,
                                             doc_len=16))


@pytest.mark.parametrize("arch,seq", [("phi-3-vision-4.2b", 32),
                                      ("phi-3-vision-4.2b", 16),
                                      ("whisper-small", 32)])
def test_device_batch_feeds_vlm_and_audio_as_the_reference(arch, seq):
    cfg = reduced(get_config(arch))
    rng = np.random.default_rng(4)
    toks = rng.integers(1, cfg.vocab_size, (2, seq + 1))
    host = {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}
    batch = launch_train.device_batch(cfg, host, 3, torch.device("cpu"))
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        # seq 16 = n_img_tokens: the tokens stay whole, as in the JAX
        # package; seq 32: the last 16 give way to the image, and the
        # labels follow the positions the model sees (the JAX package
        # keeps 48 labels for 32 positions there, and its loss raises)
        kept = seq - n if seq > n else seq
        assert batch["tokens"].tolist() == host["tokens"][:, :kept].tolist()
        assert batch["img_embeds"].shape == (2, n, cfg.img_embed_dim)
        assert not batch["img_embeds"].any()
        labels = batch["labels"].numpy()
        assert labels.shape == (2, kept + n)
        assert (labels[:, :n] == -100).all()
        np.testing.assert_array_equal(labels[:, n:], host["labels"][:, :kept])
    else:
        want = np.random.default_rng(3).normal(size=(2, seq, cfg.d_model))
        np.testing.assert_array_equal(batch["frames"].numpy(),
                                      want.astype(np.float32))
    params = init_params(tapi.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    opt = AdamW(lr=1e-3, warmup_steps=1)
    _, m = make_train_step(cfg, opt)(init_state(params, opt), batch)
    assert np.isfinite(float(m["loss"])) and \
        np.isfinite(float(m["grad_norm"]))


# -- the launcher -------------------------------------------------------------

def test_train_launcher_end_to_end(tmp_path):
    # tests/test_system.py:60-69, on the CPU
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "30",
         "--batch", "4", "--seq", "64", "--ckpt-dir", str(tmp_path / "ckpt"),
         "--ckpt-every", "15"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-1500:] + out.stderr[-1500:]
    lines = out.stdout.splitlines()
    assert lines[0].startswith("[train] arch=qwen3-1.7b family=dense") \
        and lines[0].endswith("device=cpu")
    assert lines[1].startswith("[data] corpus (256, 512)")
    assert any(ln.startswith("[step   30]") for ln in lines)
    assert lines[-1].startswith("[done] 30 steps")
    assert os.path.isdir(tmp_path / "ckpt" / "step_00000030")
    assert Checkpointer(str(tmp_path / "ckpt")).available() == [15, 30]


def test_train_launcher_without_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--steps", "1"])


def test_examples_pass_the_reference_arguments(monkeypatch, capsys):
    from repro_torch import serve_lm, train_lm
    seen = []
    monkeypatch.setattr(train_lm, "train_main",
                        lambda args: seen.append(args) or 0)
    assert train_lm.main(["--device", "cpu"]) == 0
    args = seen[0]
    assert args[:4] == ["--arch", "qwen3-1.7b", "--device", "cpu"]
    assert args[4:10] == ["--smoke", "--steps", "200", "--batch", "8",
                          "--seq"]
    assert serve_lm.main(["--device", "cpu", "--arch", "rwkv6-7b"]) == 0
    out = capsys.readouterr().out
    assert "[serve] arch=rwkv6-7b batch=4 prompt=64 new=32 device=cpu" in out
