"""Registration of the built-in kernels + public wrappers.

Each logical kernel is registered under two backends (see
``repro_torch.kernels.registry``): ``torch`` (its plain PyTorch version,
for CPU tensors) and ``cuda`` (its hand-written kernel, for CUDA
tensors). The wrappers below dispatch through the registry, so the
backend follows the tensors' device.

Three kernels register a tile grid over their CUDA launch parameter, the
autotuner's candidates (the JAX package gives the same three a grid):
``coo_expand`` ``vt`` (merge items a thread), ``masked_matmul`` ``kc``
(the K chunk in shared memory) and ``bloom_probe`` ``threads`` (the
shared path's CTA). ``merge_join`` and ``sddmm_agg`` have none.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bloom_probe, coo_join, masked_matmul as mm
from repro_torch.kernels import registry
from repro_torch.kernels.merge_join import merge_join_cuda, merge_join_plain
from repro_torch.kernels.sddmm_agg import sddmm_agg_cuda, sddmm_agg_plain

for _name, _plain, _cuda, _mod in (
        ("coo_expand", coo_join.coo_expand_plain,             # §4.4–§4.5
         coo_join.coo_expand_cuda, coo_join),
        ("bloom_probe", bloom_probe.bloom_probe_plain,        # §4.7
         bloom_probe.bloom_probe_cuda, bloom_probe),
        ("merge_join", merge_join_plain, merge_join_cuda,     # §4.3/§4.7
         None),
        ("masked_matmul", mm.masked_matmul_plain,             # §6
         mm.masked_matmul_cuda, mm),
        ("sddmm_agg", sddmm_agg_plain, sddmm_agg_cuda, None)):  # §6 (PNMF)
    _grid = dict(tile_grid=_mod.GRID, default_tiles=_mod.DEFAULT_TILES) \
        if _mod is not None else {}
    registry.register(_name, registry.TORCH, **_grid)(_plain)
    registry.register(_name, registry.CUDA, **_grid)(_cuda)


def masked_matmul(a: torch.Tensor, b: torch.Tensor,
                  out_block_mask: torch.Tensor, *,
                  block_size: int = 256) -> torch.Tensor:
    """(A×B) with whole output blocks gated by ``out_block_mask``.

    ``out_block_mask`` is [ceil(M/bs), ceil(N/bs)] bool over the OUTPUT
    tile grid — the paper's "compute only the W×H blocks under nonzero A
    blocks".
    """
    return registry.dispatch("masked_matmul", a, b, out_block_mask,
                             block_size=block_size)


def sddmm_agg(sp: torch.Tensor, w: torch.Tensor, h: torch.Tensor,
              out_block_mask: torch.Tensor, *, dim: str,
              block_size: int = 256) -> torch.Tensor:
    """SUM-aggregate ``sp ∘ (W×H)`` without materializing the product.

    ``dim``: ``"row"`` → [m, 1], ``"col"`` → [1, n], ``"all"`` → [1, 1]
    (the shapes ``core.executor.agg_dense`` produces for ``AggFn.SUM``).
    """
    return registry.dispatch("sddmm_agg", sp, w, h, out_block_mask,
                             dim=dim, block_size=block_size)
