"""Registration of the built-in kernels.

Each logical kernel is registered under two backends (see
``repro_torch.kernels.registry``): ``torch`` (its plain PyTorch version,
for CPU tensors) and ``cuda`` (its hand-written kernel, for CUDA
tensors). ``masked_matmul`` and ``sddmm_agg`` have no CUDA kernel yet:
their ``cuda`` entry raises ``NotImplementedError``.
"""
from __future__ import annotations

from repro_torch.kernels import registry
from repro_torch.kernels.bloom_probe import bloom_probe_cuda, bloom_probe_plain
from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
from repro_torch.kernels.merge_join import merge_join_cuda, merge_join_plain
from repro_torch.kernels.ref import masked_matmul_ref, sddmm_agg_ref


def _not_ported(name: str):
    def fn(*args, **kw):
        raise NotImplementedError(
            f"{name} has no CUDA kernel yet (ROADMAP, TPU kernels to port: "
            "the PNMF slice, masked_matmul and sddmm_agg)")
    return fn


for _name, _plain, _cuda in (
        ("coo_expand", coo_expand_plain, coo_expand_cuda),      # §4.4–§4.5
        ("bloom_probe", bloom_probe_plain, bloom_probe_cuda),   # §4.7
        ("merge_join", merge_join_plain, merge_join_cuda),      # §4.3/§4.7
        ("masked_matmul", masked_matmul_ref,                    # §6 (PNMF)
         _not_ported("masked_matmul")),
        ("sddmm_agg", sddmm_agg_ref, _not_ported("sddmm_agg"))):
    registry.register(_name, registry.TORCH)(_plain)
    registry.register(_name, registry.CUDA)(_cuda)
