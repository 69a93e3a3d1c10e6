"""Kernels behind the relational operators, with backend dispatch.

* ``registry``     — logical kernel name → ``torch`` / ``cuda`` impls,
                     chosen by the tensors' device.
* ``ops``          — registration of the built-ins + public wrappers.
* ``coo_join``     — ``coo_expand``: fused COO join expansion (§4.4–§4.5).
* ``bloom_probe``  — V2V Bloom-join membership probe (§4.7).
* ``merge_join``   — block-skip overlay join (§4.3/§4.7).
* ``merge_codes``  — merge callables → op codes a CUDA kernel evaluates.
* ``build``        — ``nvcc`` build + ``ctypes`` load of ``csrc/*.cu``,
                     and the launch counts.
* ``ref``          — plain versions of the PNMF kernels (``masked_matmul``,
                     ``sddmm_agg``), which have no CUDA kernel yet.

Each kernel module keeps its plain PyTorch version beside its CUDA
wrapper; the CPU tests use the first, the card the second.
"""
