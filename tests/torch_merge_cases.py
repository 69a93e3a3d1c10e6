"""Merges for the tests of the merge compiler (``kernels.merge_codes``)
and of the generated instances of ``merge_join`` and ``coo_expand``:
names, torch callables, and whether every op in them is IEEE-exact (else
they hold a transcendental of the op set and are compared within
``TRANSCENDENTAL_ULPS``)."""
import numpy as np
import torch
import torch.nn.functional as F

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


def _long(x, y):
    r = x
    for _ in range(20):
        r = r * y + x
    return r


def _wide(x, y):
    t = [x * x + float(k) for k in range(8)]   # ten values live
    return sum(t[1:], t[0]) + y


def _ints(x, y):
    """Two int64 values: where() of Python ints is int64."""
    return torch.where(x > 0, 7, -3), torch.where(y > 1, 2, -5)


def _int_arith(x, y):
    k, j = _ints(x, y)
    return (k * j + k - j) * y + (k // j + k % j - (-k) // j)


def _int_bitwise(x, y):
    k, j = _ints(x, y)
    return ((k & 6) | (j ^ 3)) * x - (~k) * y


def _casts(x, y):
    """Through float16, bfloat16 and int32 and back."""
    return x.half().float() * y.bfloat16().to(x.dtype) \
        + x.to(torch.int32).to(x.dtype)


def _like(x, y):
    return torch.where(x > 0, torch.zeros_like(x), torch.full_like(y, 0.5)) \
        + y


def _narrow_ints(x, y):
    """int8, int16, uint8, int32 and int64 arithmetic, each in its width
    (wrapping), promoted as torch promotes them."""
    a, b, c = x.char(), y.short(), x.byte()
    return (a + b * 3 - c // 2 + (a & 5)).float() \
        + (y.int() % 7 - (c >> 1) * a).double() + x.long() * y.bool()


def _reduced(x, y):
    """float16 and bfloat16 ops computed in float32, rounded after each."""
    h, g = x.half(), y.half()
    b, c = x.bfloat16(), y.bfloat16()
    return (h * g + 1.5 - h / g).float() + (b * c - b + 0.25).to(x.dtype) \
        + torch.maximum(h, g).double() - torch.floor(c * 3).float()


def _shifts(x, y):
    k, j = _ints(x, y)
    return (torch.gcd(k * 6, j * 4) + torch.lcm(k, j) + (k << 2) - (j >> 1)
            + torch.bitwise_left_shift(k, 70)
            + torch.bitwise_right_shift(j, -1) + (3 << j.abs())
            + (x.char() << 3) - (y.char() >> 2)) * y


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
    # the ops the register programs refused
    "erf": (lambda x, y: torch.erf(x) * y, False),
    "erfc": (lambda x, y: torch.erfc(x) - y.erf(), False),
    "trig": (lambda x, y: torch.sin(x) * torch.cos(y) + torch.tan(x * 0.5),
             False),
    "inverse_trig": (lambda x, y: torch.asin(x * 0.05)
                     + torch.acos(y * 0.05) - torch.atan(x), False),
    "hyperbolic": (lambda x, y: torch.sinh(x * 0.1) - torch.cosh(y * 0.1)
                   + torch.asinh(x) + torch.acosh(2 + torch.abs(y))
                   + torch.atanh(x * 0.05), False),
    "exp2_log2_log10": (lambda x, y: torch.exp2(x * 0.5)
                        + torch.log2(torch.abs(y))
                        - torch.log10(torch.abs(x)), False),
    "rounding": (lambda x, y: torch.floor(x) + torch.ceil(y) * 2
                 - torch.round(x * 4) + torch.trunc(y * 3) + torch.frac(x)
                 + y.round() - x.fix(), True),
    "remainder": (lambda x, y: x % y - torch.remainder(y, 1.5)
                  + torch.fmod(x, -2.0), True),
    "fmod": (lambda x, y: torch.fmod(x, y) - y.fmod(x), True),
    "floor_divide": (lambda x, y: x // y + torch.div(
        y, x, rounding_mode="floor"), True),
    "div_trunc": (lambda x, y: torch.div(x, y, rounding_mode="trunc"), True),
    "floordiv_const": (lambda x, y: x // 0.75 + y, True),
    "atan2_hypot": (lambda x, y: torch.atan2(x, y) + torch.hypot(x, y),
                    False),
    "fmax_fmin": (lambda x, y: torch.fmax(x, y) - torch.fmin(x, y * 2.0),
                  True),
    "copysign": (lambda x, y: torch.copysign(x, y) * 2
                 + torch.copysign(y, -1.0), True),
    "relu": (lambda x, y: torch.relu(x) - torch.nn.functional.relu(y),
             True),
    "predicates": (lambda x, y: torch.where(torch.isnan(x) | torch.isinf(y),
                                            1.0, 0.0)
                   + torch.isfinite(x) * 2 - torch.signbit(y) * 4, True),
    "logical_xor": (lambda x, y: torch.logical_xor(x > 0, y) * x
                    + ((x > 0) ^ (y < 0)) * y, True),
    "alpha": (lambda x, y: torch.add(x, y, alpha=3.1)
              - torch.sub(y, x, alpha=0.7) + torch.rsub(x, y, alpha=2), True),
    # torch's typing: bool + bool is bool (or), bool * bool and, int64
    # arithmetic, int64 / int64 float32, float32 against T, a 0-d float64
    # constant over a bool promotes to float64
    "bool_plus_bool": (lambda x, y: ((x > 0) + (y > 0)) * x
                       + ((x > 0) * (y < 0)) * y, True),
    "int_arith": (_int_arith, True),
    "int_bitwise": (_int_bitwise, True),
    "int_truediv": (lambda x, y: _ints(x, y)[0] / _ints(x, y)[1] + x, True),
    "int_pow": (lambda x, y: (_ints(x, y)[0] ** 2
                              + _ints(x, y)[0] ** _ints(x, y)[1].abs()) * y,
                True),
    "f32_vs_value": (lambda x, y: torch.where(
        torch.where(x > 0, 0.1, 0.2) < y, x, y), True),
    "bool_float": (lambda x, y: ((x > 0) + 1.5) * y
                   + torch.where(x > 0, 3, 4) * 0.1, True),
    "zero_d_f64": (lambda x, y: (x > 0) * torch.tensor(
        0.1, dtype=torch.float64) + y, True),
    # no limit on the length or the live values
    "long": (_long, True),
    "wide": (_wide, True),
    # aliases of ops in the set
    "special_aliases": (lambda x, y: torch.special.erf(x)
                        + torch.special.erfc(y)
                        + torch.special.exp2(x * 0.5)
                        - torch.special.expm1(y * 0.1)
                        + torch.special.log1p(x.abs())
                        * torch.special.expit(y), False),
    "round_decimals": (lambda x, y: torch.round(x, decimals=2)
                       + torch.special.round(y) - x.round(decimals=-1)
                       + torch.sgn(x) * y, True),
    # casts, reduced dtypes and narrow integers, constructors
    "casts": (_casts, True),
    "narrow_ints": (_narrow_ints, True),
    "reduced": (_reduced, True),
    "like": (_like, True),
    "like_typed": (lambda x, y: torch.ones_like(x, dtype=torch.float64) * x
                   + torch.full_like(x, 3, dtype=torch.int32) * y
                   + torch.zeros_like(y, dtype=torch.bool), True),
    "type_as": (lambda x, y: x.type(torch.float16).type_as(y)
                + y.to(dtype=torch.bfloat16).to(x) + x.to(torch.bool)
                - y.double().float() + x.bool(), True),
    # activations
    "activations": (lambda x, y: F.gelu(x) * F.silu(y) + F.softplus(x),
                    False),
    "activations_elu": (lambda x, y: F.gelu(x, approximate="tanh")
                        + F.elu(y) - F.selu(x) + F.celu(y, alpha=0.5)
                        + F.mish(x * 0.1), False),
    "activations_exact": (lambda x, y: F.leaky_relu(x, 0.2)
                          + F.hardtanh(y) * F.relu6(x) + F.hardsigmoid(y)
                          - F.hardswish(x), True),
    "activations_log": (lambda x, y: F.logsigmoid(x) + F.softsign(y)
                        + F.softplus(x, beta=2, threshold=5), False),
    # other elementwise functions of jnp
    "logaddexp": (lambda x, y: torch.logaddexp(x, y)
                  - torch.logaddexp2(x * 0.5, y), False),
    "nan_to_num": (lambda x, y: torch.nan_to_num(x)
                   + torch.nan_to_num(y, nan=1.5, posinf=2.0, neginf=-2.0)
                   + torch.heaviside(x, y), True),
    "float_power": (lambda x, y: torch.float_power(x.abs(), y)
                    + torch.float_power(x, 2) + torch.ldexp(x, torch.round(
                        y.clamp(-20, 20))), False),
    "deg_sinc": (lambda x, y: torch.deg2rad(x) + torch.rad2deg(y)
                 + torch.sinc(x) + torch.special.sinc(y * 0.5), False),
    "nextafter_isclose": (lambda x, y: torch.nextafter(x, y)
                          + torch.isclose(x, y) + 2 * torch.isclose(
                              x, y * 1.01, rtol=0.02, atol=0.1,
                              equal_nan=True)
                          + torch.isposinf(x) * 4 + torch.isneginf(y) * 8
                          + torch.isreal(x), True),
    "shifts_gcd": (_shifts, True),
    # the special functions of jax.scipy.special
    # a product: libm's lgamma and torch's differ in the last bit, which a
    # cancelling sum (lgamma(x) + digamma(y), chip_smoke.py's) magnifies
    # beyond the scale of the result on the host (the card's are one)
    "gamma": (lambda x, y: torch.lgamma(x) * torch.digamma(y), False),
    "gamma_aliases": (lambda x, y: torch.special.gammaln(x)
                      * torch.special.psi(y * 0.5), False),
    # erfinv and ndtri take IEEE-exact arguments: near ±1 and 0 or 1 they
    # magnify a last-bit difference of tanh or sigmoid between libm and
    # torch's vector math (on the card both are CUDA's: chip_smoke.py's
    # merge composes them)
    "normal": (lambda x, y: torch.special.ndtr(x) * torch.erfinv(y * 0.125)
               + torch.special.ndtri(y * 0.0625 + 0.5)
               - torch.special.log_ndtr(x), False),
    "bessel": (lambda x, y: torch.special.i0e(x) - torch.special.i1(y * 0.1)
               + torch.i0(x * 0.1) + torch.special.i1e(y), False),
    "xlogy": (lambda x, y: torch.special.xlogy(x, y)
              + torch.special.xlog1py(y, x) + torch.special.entr(x), False),
    "logit": (lambda x, y: torch.logit(torch.sigmoid(x))
              + torch.special.logit(y, eps=1e-3), False),
    "zeta": (lambda x, y: torch.special.zeta(x.abs() + 1, y.abs() + 1)
             * torch.special.zeta(x, 2.0), False),
    "polygamma": (lambda x, y: torch.polygamma(1, x) * torch.special.polygamma(
        2, y) + x.polygamma(3) * torch.polygamma(0, y), False),
}

# merges that divide by a constant: torch on the card multiplies by the
# reciprocal of a CPU-scalar divisor (one rounding more), while the kernels
# divide, as torch on the CPU and the JAX package do; on the card they are
# held to the plain version on the CPU
CARD_RECIPROCAL = frozenset({"div_by_3", "neg_sub", "floordiv_const"})

# merges the compiler refuses, each naming its cause
REFUSED = {
    "python_branch": (lambda x, y: x if x > 0 else y, "Python branch"),
    "tensor_constant": (lambda x, y: x * torch.ones(3), "tensor constant"),
    "reduction": (lambda x, y: torch.sum(x) * y, "non-elementwise op"),
    "method_reduction": (lambda x, y: x.cumsum(0) + y, "non-elementwise op"),
    "indexing": (lambda x, y: x[0] * y, "indexing"),
    "random": (lambda x, y: torch.rand_like(x) * y, "random op"),
    "outside_the_set": (lambda x, y: F.hardshrink(x) * y, "outside the op"),
    "complex": (lambda x, y: torch.polar(x, y).real, "outside the op"),
    "empty_like": (lambda x, y: torch.empty_like(x) + y,
                   "uninitialised values"),
    "special_outside_the_rule": (lambda x, y: torch.special.erfcx(x) * y,
                                 "outside the op"),
    "inplace_activation": (lambda x, y: F.silu(x, inplace=True) + y,
                           "in-place silu"),
    "device_move": (lambda x, y: x.to("cuda") + y, "device move"),
    "mvlgamma": (lambda x, y: torch.mvlgamma(x, 2) * y, "checks its data"),
    "torch_refuses": (lambda x, y: (x > 0) - (y > 0), "Subtraction"),
}

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


# merges IEEE-exact on the card whose ops torch's CPU build takes from a
# vector library (MKL's sqrt is not correctly rounded): on the CPU they
# are held as the transcendental ones
CPU_VECTOR_MATH = frozenset({"sqrt"})


def _near(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Within TRANSCENDENTAL_ULPS ulps, at the scale of max(|want|, 1);
    equal values and NaN against NaN pass."""
    scale = torch.clamp(want.abs().nan_to_num(posinf=1.0), min=1.0)
    ulp = torch.nextafter(scale, torch.full_like(scale, np.inf)) - scale
    close = (got - want).abs() <= TRANSCENDENTAL_ULPS * ulp
    return close | (got == want) | (torch.isnan(got) & torch.isnan(want)) \
        | (ulps(got, want) <= TRANSCENDENTAL_ULPS)


def _same_bits(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    ints = torch.int64 if got.dtype == torch.float64 else torch.int32
    return (got.view(ints) == want.view(ints)) \
        | (torch.isnan(got) & torch.isnan(want))


def check_host(got: torch.Tensor, fn, x: torch.Tensor, y: torch.Tensor,
               exact: bool, name=""):
    """The emitted function compiled for the host (``got``) against the
    merge ``fn`` on the CPU tensors ``x``, ``y``. Exact merges bit for
    bit. The others within TRANSCENDENTAL_ULPS ulps at the scale of
    max(|want|, 1): torch's CPU build takes its transcendentals from
    vector libraries (MKL, SLEEF), the host from libm, and one op's
    last-bit difference survives a cancelling sum at the scale of its
    terms. An element that fails is held again to the merge on that
    element alone, which torch computes in its scalar loop, and a float32
    element of a transcendental merge to the merge on float64 operands,
    rounded: the vector loops are not faithful on subnormals (fmod(1e-45,
    1) and remainder(3e38, 0.5) are NaN there, and log1p(1e-45) is 0 even
    alone, so exp(inf) * log1p(1e-45) is NaN)."""
    want = fn(x, y)
    want = (want if isinstance(want, torch.Tensor)
            else torch.tensor(want)).to(x.dtype).expand_as(x)
    assert got.dtype == want.dtype and got.shape == want.shape, name
    same = _same_bits if exact else _near
    bad = ~same(got, want)
    idx = bad.nonzero().flatten()
    if idx.numel():
        alone = torch.cat([fn(x[i:i + 1], y[i:i + 1]).to(x.dtype)
                           .reshape(1) for i in idx.tolist()])
        bad[idx] = ~same(got[idx], alone)
        if not exact and x.dtype == torch.float32:
            wide = fn(x[idx].double(), y[idx].double()).to(x.dtype)
            bad[idx] &= ~same(got[idx], wide)
    assert not bool(bad.any()), (
        f"{name}: {int(bad.sum())} elements beyond "
        f"{0 if exact else TRANSCENDENTAL_ULPS} ulp, e.g. got "
        f"{got[bad][:4].tolist()} want {want[bad][:4].tolist()}")
