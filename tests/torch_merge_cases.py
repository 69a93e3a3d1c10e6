"""Merges for the tests of the merge compiler (``kernels.merge_codes``)
and of the program instances of ``merge_join`` and ``coo_expand``: names,
torch callables, and whether every op in them is IEEE-exact (else they
hold a transcendental of the op set and are compared within
``TRANSCENDENTAL_ULPS``)."""
import numpy as np
import torch

# the kernels' transcendentals are CUDA's math library, the plain
# versions' torch's (the same library on the card, libm/SLEEF on the CPU)
TRANSCENDENTAL_ULPS = 4


def _flip(f):
    return lambda x, y: f(y, x)


def _gated(x, y):
    """The JAX package's gated merge (``tests/test_memo_search.py``)."""
    return torch.where(x < 10, x + y, 0.0)


def _every_register(x, y):
    """Eight values live at once: x, y and six temporaries."""
    t1, t2, t3 = x + 1.0, y + 2.0, x * x
    t4, t5, t6 = x - y, x * 3.0, y * 5.0
    return ((((t1 + t2) + (t3 + t4)) + (t5 + t6)) + x) + y


# name: (merge, exact)
GENERAL = {
    # the five merges the kernels refused before the compiler
    "square": (lambda x, y: x * x, True),
    "quotient": (lambda x, y: x / y, True),
    "xy2": (lambda x, y: x * y * y, True),
    "where": (lambda x, y: torch.where(x > 0, x, y), True),
    "abs": (lambda x, y: abs(x) + y, True),
    "gated": (_gated, True),
    "flipped_gated": (_flip(_gated), True),
    "every_register": (_every_register, True),
    "div_by_3": (lambda x, y: x / 3 + y, True),
    "neg_sub": (lambda x, y: -x - y / 0.1 + 1, True),
    "maximum": (torch.maximum, True),
    "minimum": (lambda x, y: torch.minimum(x, y), True),
    "max_min": (lambda x, y: torch.max(x, y) - torch.min(x, 2.0 * y), True),
    "clamp": (lambda x, y: torch.clamp(x * y, -1.0, 1.0), True),
    "clamp_by_operand": (lambda x, y: torch.clamp(x, min=y), True),
    "clamp_min_max": (lambda x, y: x.clamp_min(0) + y.clamp_max(0.5), True),
    "compare": (lambda x, y: (x < y) * x + (x <= y) * y - (x > y) * x
                + (x >= y) * y * 0.5 + (x == y) * x - (x != y) * y, True),
    "logic": (lambda x, y: torch.where((x > 0) & ~(y < 0) | (x == y),
                                       x - y, y), True),
    "logical": (lambda x, y: torch.logical_and(x, y) * x
                + torch.logical_or(x > 1, torch.logical_not(y)), True),
    "sign": (lambda x, y: torch.sign(x) * y, True),
    "bool_times": (lambda x, y: (x > 0) * y, True),
    "where_consts": (lambda x, y: torch.where(x > 0, 0.1, -2.5) * y, True),
    "where_ints": (lambda x, y: torch.where(y >= x, 3, -7) + x, True),
    "int_powers": (lambda x, y: x ** 2 + y ** 3 - x ** -1 + y ** -2
                   + x ** 0 + y ** 1, True),
    "sqrt": (lambda x, y: torch.sqrt(torch.abs(x)) + x ** 0.5 - y, True),
    "reciprocal_square": (lambda x, y: torch.reciprocal(x)
                          + torch.square(y), True),
    "consts": (lambda x, y: x * torch.tensor(0.1) + True
               + torch.tensor(3.0, dtype=torch.float64) * y
               - torch.tensor(2) + 7 + np.float32(0.3) * x, True),
    "constant": (lambda x, y: torch.tensor(2.5), True),
    "methods": (lambda x, y: x.abs().clamp(max=5.0).neg() + y.square(),
                True),
    "exp_log1p": (lambda x, y: torch.exp(x) * torch.log1p(torch.abs(y)),
                  False),
    "pow": (lambda x, y: torch.abs(x) ** y, False),
    "pow_const": (lambda x, y: x ** 2.5 + 2.0 ** y, False),
    "rsqrt": (lambda x, y: x ** -0.5 + torch.rsqrt(torch.abs(y)), False),
    "log_expm1": (lambda x, y: torch.log(torch.abs(x)) + torch.expm1(y),
                  False),
    "tanh_sigmoid": (lambda x, y: torch.tanh(x) - y.sigmoid(), False),
}

# merges that divide by a constant: torch on the card multiplies by the
# reciprocal of a CPU-scalar divisor (one rounding more), while the kernels
# divide, as torch on the CPU and the JAX package do; on the card they are
# held to the plain version on the CPU
CARD_RECIPROCAL = frozenset({"div_by_3", "neg_sub"})

# merges the compiler refuses, each naming its cause
REFUSED = {
    "unknown_op": (lambda x, y: torch.erf(x) * y, "erf"),
    "python_branch": (lambda x, y: x if x > 0 else y, "Python branch"),
    "tensor_constant": (lambda x, y: x * torch.ones(3), "tensor constant"),
    "too_many_instructions": (None, "instructions"),
    "too_many_registers": (None, "registers"),
}


def _long(x, y):
    r = x
    for _ in range(20):
        r = r * y + x
    return r


def _wide(x, y):
    t = [x * x + float(k) for k in range(8)]   # ten values live
    return sum(t[1:], t[0]) + y


REFUSED["too_many_instructions"] = (_long, "instructions")
REFUSED["too_many_registers"] = (_wide, "registers")

# the values of the special grid: signed zeros, infinities, NaN,
# subnormals (of float32 and float64), large and small
SPECIALS = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                     1e-310, 3e38, -3e38, 1e300, 1e-30, 1.0, -1.0, 0.5, 2.0,
                     10.0, -3.0, 12.5, 1e-7])


def operands(seed, dtype):
    """Random values, then every pair of ``SPECIALS``: x and y as numpy."""
    rng = np.random.default_rng(seed)
    n = 4096
    x = np.concatenate([rng.normal(size=n) * 4, np.repeat(SPECIALS,
                                                          SPECIALS.size)])
    y = np.concatenate([rng.normal(size=n) * 4, np.tile(SPECIALS,
                                                        SPECIALS.size)])
    with np.errstate(over="ignore"):        # 1e300 is inf in float32
        return x.astype(dtype), y.astype(dtype)


def ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Units in the last place between two tensors of one float dtype,
    element by element (int64): 0 where both are NaN, 2**62 where one is
    and as the most it reports."""
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    bits = [t.contiguous().reshape(-1).view(ints).tolist()
            for t in (got, want)]
    low = -(1 << (64 if ints == torch.int64 else 32) - 1)
    nan_g = torch.isnan(got).reshape(-1).tolist()
    nan_w = torch.isnan(want).reshape(-1).tolist()
    out = []
    for bg, bw, ng, nw in zip(*bits, nan_g, nan_w):
        if ng or nw:
            out.append(0 if ng and nw else 1 << 62)
        else:
            # a monotone map of the bit patterns onto the integers
            og = low - bg if bg < 0 else bg
            ow = low - bw if bw < 0 else bw
            out.append(min(abs(og - ow), 1 << 62))
    return torch.tensor(out, dtype=torch.int64).reshape(got.shape)


def check(got: torch.Tensor, want: torch.Tensor, exact: bool, name=""):
    """Bit for bit, signed zeros included (NaN against any NaN), when
    ``exact``; else within ``TRANSCENDENTAL_ULPS``."""
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if exact:
        ints = torch.int64 if got.dtype == torch.float64 else torch.int32
        bad = (got.view(ints) != want.view(ints)) \
            & ~(torch.isnan(got) & torch.isnan(want))
        limit = 0
    else:
        limit = TRANSCENDENTAL_ULPS
        bad = ulps(got, want) > limit
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements beyond {limit} ulp, e.g. got "
        f"{got[bad][:4].tolist()} want {want[bad][:4].tolist()}")
