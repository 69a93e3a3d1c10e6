"""The port's serving steps (``repro_torch.serve.step``) and its LM
launcher, on the CPU.

The four contracts of ``tests/test_serve_step.py``, ported: each step is
built once per key (``trace_count`` counts builds: eager PyTorch runs the
body on every call), the cached objects are reused and LRU-bounded, and a
donating decode gives the non-donating one's tokens. A non-donating step
leaves the caller's caches as they were; a donating one updates them in
place. ``generate``'s f32 tokens equal the JAX package's ``generate``'s on
the same parameters. The launcher's ``--arch`` path prints the JAX
package's three ``[serve]`` lines on the CPU and refuses to run without a
card unless asked for the CPU.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import step as ref_step
from repro_torch.configs import get_config, reduced
from repro_torch.models import api as tapi
from repro_torch.models.module import init_params, tree_items, tree_map
from repro_torch.serve import step as stepmod
from repro_torch.serve.step import (compiled_decode, compiled_prefill,
                                    generate, trace_count)

from torch_lm_helpers import params_pair, port_cfg, ref_cfg

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture()
def tiny():
    cfg = reduced(get_config("qwen3-1.7b"))
    params = init_params(tapi.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, (2, 8)),
                             dtype=torch.int32)
    return cfg, params, prompt


def test_generate_compiles_each_step_once(tiny):
    cfg, params, prompt = tiny
    max_seq = 16
    out1 = generate(params, cfg, prompt, n_new=4, max_seq=max_seq)
    n_prefill = trace_count("prefill", cfg, max_seq)
    n_decode = trace_count("decode", cfg, True, False)
    assert n_prefill == 1
    assert n_decode == 1           # 3 decode calls, one build

    out2 = generate(params, cfg, prompt, n_new=4, max_seq=max_seq)
    assert trace_count("prefill", cfg, max_seq) == n_prefill
    assert trace_count("decode", cfg, True, False) == n_decode
    np.testing.assert_array_equal(out1.numpy(), out2.numpy())


def test_compiled_steps_are_cached_objects(tiny):
    cfg, params, prompt = tiny
    assert compiled_prefill(cfg, 16) is compiled_prefill(cfg, 16)
    assert compiled_decode(cfg) is compiled_decode(cfg)
    # distinct shapes / donation settings are distinct entries
    assert compiled_prefill(cfg, 16) is not compiled_prefill(cfg, 24)
    assert compiled_decode(cfg) is not compiled_decode(cfg, donate=True)


def test_step_cache_is_bounded(tiny):
    cfg, _params, _prompt = tiny
    cap = stepmod._STEP_CACHE.capacity
    assert cap == 16
    for m in range(16, 16 + cap + 4):
        compiled_prefill(cfg, m)
    assert len(stepmod._STEP_CACHE) <= cap


def test_donating_decode_matches_nondonating(tiny):
    cfg, params, prompt = tiny
    max_seq = 16
    prefill = compiled_prefill(cfg, max_seq)
    logits, caches = prefill(params, {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    before = tree_map(torch.clone, caches)

    _, t_plain, c_plain = compiled_decode(cfg)(params, caches, tok,
                                               prompt.shape[1])
    # the non-donating step left the caller's caches as they were
    for (_, a), (_, b) in zip(tree_items(caches), tree_items(before)):
        assert torch.equal(a, b)
    _, t_donate, c_donate = compiled_decode(cfg, donate=True)(
        params, caches, tok, prompt.shape[1])
    np.testing.assert_array_equal(t_plain.numpy(), t_donate.numpy())
    # the donating one wrote the new slot into them
    assert c_donate is caches
    for (_, a), (_, b) in zip(tree_items(c_donate), tree_items(c_plain)):
        assert torch.equal(a, b)
    assert int(caches["pos0"]["pos"][0, 0, prompt.shape[1]]) == \
        prompt.shape[1]


def test_generate_matches_reference_generate_f32():
    arch = "qwen3-1.7b"
    ref, port = params_pair(arch, "f32")
    cfg, rcfg = port_cfg(arch, "f32"), ref_cfg(arch, "f32")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, cfg.vocab_size, (2, 12)).astype(np.int32)
    want = ref_step.generate(ref, rcfg, jnp.asarray(prompt), n_new=6,
                             max_seq=24)
    got = generate(port, cfg, torch.as_tensor(prompt), n_new=6, max_seq=24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert jax.default_backend() == "cpu"


def test_launcher_serves_an_arch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch", "2",
         "--prompt-len", "16", "--new-tokens", "8"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("[serve]")]
    assert len(lines) == 3, res.stdout
    assert lines[0].startswith("[serve] arch=qwen3-1.7b batch=2 prompt=16 "
                               "new=8")
    assert "ms/tok" in lines[1] and "tok/s" in lines[1]
    assert lines[2].startswith("[serve] sample tokens: [")


def test_launcher_without_a_card_raises(monkeypatch, capsys):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "qwen3-1.7b", "--smoke", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "8"])
    assert "[serve]" not in capsys.readouterr().out
