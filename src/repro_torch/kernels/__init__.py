"""Kernels behind the relational operators, with backend dispatch.

* ``registry``     — logical kernel name → ``torch`` / ``cuda`` impls,
                     chosen by the tensors' device, with each kernel's
                     tile grid (its CUDA launch parameter).
* ``autotune``     — tile autotuner keyed by ``(kernel, shape-bucket,
                     dtype, backend, device kind)`` with an in-process
                     + on-disk JSON cache (the warm-start artifact).
* ``ops``          — registration of the built-ins + public wrappers.
* ``coo_join``     — ``coo_expand``: fused COO join expansion (§4.4–§4.5).
* ``bloom_probe``  — V2V Bloom-join membership probe (§4.7).
* ``merge_join``   — block-skip overlay join (§4.3/§4.7).
* ``masked_matmul`` — block-masked W×H under live blocks of A (§6, PNMF).
* ``sddmm_agg``    — fused SUM of ``sp ∘ (W×H)`` (§6, PNMF).
* ``merge_codes``  — merge callables → codes, or C++ emitted per merge,
                     that the CUDA kernels evaluate.
* ``build``        — ``nvcc`` build + ``ctypes`` load of ``csrc/*.cu``,
                     and the launch counts.

Each kernel module keeps its plain PyTorch version beside its CUDA
wrapper; the CPU tests use the first, the card the second.
"""
