"""Newton–Schulz batched inversion.

No reference counterpart: the reference's fastest path is cuBLAS batched
LU (``src/gauss/inverse_gpu.cu:16-58``).  Newton–Schulz iteration

    X_{k+1} = X_k (2I − A X_k)

is pure batched matrix products and converges quadratically whenever
‖I − X₀A‖ < 1, which the scaled-transpose start X₀ = Aᵀ/(‖A‖₁‖A‖∞)
guarantees for any nonsingular A (Pan & Schreiber, SIAM J. Sci. Stat.
Comput. 12(5), 1991).

Two schedules:

* **adaptive** (:func:`inverse_newton_schulz`): a bf16-pass contraction
  phase under a device-side ``lax.while_loop`` that monitors ‖I − AX‖∞,
  then an fp32 continuation and polish.  Finite for any nonsingular A up
  to κ ≈ 1e4; its fp32 floor grows with κ, and the 1e-4 gate holds to
  κ ≈ 100 (README).
* **fixed**: scaled rounds whose count and recentering scalars are
  compile-time constants, calibrated per lane for a stated κ domain.
  :func:`inverse_newton_schulz_pallas` runs them as one Triton program per
  matrix (A read once, every iterate kept on chip) for n ≤ 128;
  :func:`inverse_newton_schulz_fixed` is the same per-matrix computation
  under ``vmap`` in plain XLA, which serves n > 128.

Every product names its algorithm (:mod:`.precision`): contraction rounds
are one bf16 pass (``BF16``) or the 3-pass split (``BF16_X3``, the
``split3`` lane); the residual that decides the 1e-4 gate is fp32-class
(``BF16_X6``).  The κ domains below were calibrated with exactly those
products and hold on any backend that honours the presets.
"""

from __future__ import annotations

import functools
import os
import warnings

import jax
import jax.numpy as jnp
from jax import lax

from cuda_matrix_inversion_tpu.ops.precision import BF16, BF16_X3, BF16_X6, F32

# Default (lo_iters, hi_iters) schedules of the fixed-iteration lanes,
# calibrated with one-pass bf16 products to hold the 1e-4 gate to κ ≲ 30
# (see inverse_newton_schulz_pallas DOMAIN notes; scaled rounds,
# scaled_round_coeffs).  On an H100 the κ=30 edge gives 3.0e-5 (spd) and
# 2.6e-5 (pan), and pan 3.4e-5 at κ≈100 nonsymmetric (chip_smoke.py).
SPD_SCHEDULE = (6, 2)
PAN_SCHEDULE = (12, 2)

# The high-κ general-matrix schedule (precision="split3"): every product
# runs as the 3-pass bf16 split (~2⁻¹⁷ relative, vs 2⁻⁹ one-pass), which
# moves the contraction floor from 2⁻⁹·κ to 2⁻¹⁷·κ — the κ ≲ 30 bf16
# domain becomes κ ≲ 500.  Calibrated by faithful-bf16 emulation (operands
# rounded through ml_dtypes.bfloat16, fp32 accumulate): lo=14 is the edge
# (lo=12 fails at 0.66 — the recentering schedule squashes EVERY input to
# the tracked interval, so convergence is schedule-global), hi=2 needed
# (hi=1 → 8e-4); emulated gate 1.5e-5 at κ=500 nonsymmetric geomspace,
# 3.1e-5 at κ=1000, n=128.  MU_MIN_PAN500: the square_5 fixture class
# (κ-capped 4·dim Ginibre) measures µ = σmin²/(‖A‖₁‖A‖∞) ≥ 1.5e-7 at
# n=128 — 3e-8 keeps 5× margin.
PAN500_SCHEDULE = (14, 2)
MU_MIN_PAN500 = 3e-8
# split3 round noise is ~2⁻¹⁷ ≈ 7.6e-6 (vs 2⁻⁹ one-pass): the squashed
# bottom edge 4·floor/(1+floor)² ≈ 8e-4 keeps a 100× noise margin while
# letting the recentering scalars stay near 2 longer than the bf16
# clamp (5e-3) would allow.
SPLIT3_NOISE_FLOOR = 2e-4

# Assumed lower edge of spec(A·X_start) for the scaled-round schedules,
# calibrated to the κ ≲ 30 domain.  A matrix whose true edge is HIGHER
# than assumed stays strictly inside every scheduled interval (safe);
# lower means out of the κ domain.  spd: µ = sλ(2−sλ) ≥ ~2λmin/‖A‖∞.
# pan: µ = σ²/(‖A‖₁‖A‖∞).
MU_MIN_SPD = 0.01
MU_MIN_PAN = 2e-5

#: Largest n the Triton kernel serves: one program holds A, X and a
#: round's product (three n×n fp32 tiles) in registers and shared memory.
#: Larger n runs the same schedule through plain XLA.
KERNEL_MAX_N = 128

#: Set to "1" to run the Pallas kernels in the Pallas interpreter (the CPU
#: test suite does; see tests/conftest.py).  Never inferred from the
#: backend: on the CPU backend an un-interpreted kernel raises.
INTERPRET_ENV = "CMI_PALLAS_INTERPRET"


def _residual_inf(eye, ax):
    """‖I − AX‖∞ max over the batch (one pass over the already-computed AX)."""
    return jnp.max(jnp.sum(jnp.abs(eye - ax), axis=-1))


@functools.partial(jax.jit, static_argnames=("max_iters", "polish_iters", "tol",
                                             "init"))
def inverse_newton_schulz(
    a: jnp.ndarray,
    max_iters: int = 48,
    polish_iters: int = 1,
    tol: float = 1e-2,
    init: str = "pan",
) -> jnp.ndarray:
    """Batched inverse via adaptive Newton–Schulz.

    ``tol`` is the bf16-phase exit residual; quadratic convergence plus
    ``polish_iters`` fp32 steps take it to fp32 roundoff.  With the
    default ``init="pan"`` works for any nonsingular (not just SPD)
    matrix; singular inputs yield non-finite entries, matching the LU
    path's behavior.  ``init="spd"`` (SPD inputs only, caller-asserted)
    starts from X₁ = 2sI − s²A, s = 1/‖A‖∞ — about half the contraction
    iterations.

    Each ``while_loop`` iteration ends in a device-side predicate; on the
    GPU the loop's control flow reads it on the host once per iteration.
    """
    if init not in ("pan", "spd"):
        raise ValueError(f"init must be 'pan' or 'spd', got {init!r}")
    if a.dtype == jnp.float64:
        # f64 callers want exactness, not the bf16 fast path — use the
        # factorization route, which stays f64 end to end.
        from cuda_matrix_inversion_tpu.ops import xla as _xla

        return _xla.inverse_lu(a)
    orig_dtype = a.dtype
    a = a.astype(jnp.float32)
    n = a.shape[-1]
    eye = jnp.eye(n, dtype=jnp.float32)

    r_inf = jnp.max(jnp.sum(jnp.abs(a), axis=2), axis=1)  # ‖A‖∞ per matrix
    if init == "spd":
        s = (1.0 / r_inf)[:, None, None]
        x0 = 2.0 * s * eye - (s * s) * a  # X₁ for X₀ = sI, computed exactly
    else:
        c_1 = jnp.max(jnp.sum(jnp.abs(a), axis=1), axis=1)    # ‖A‖₁ per matrix
        x0 = jnp.swapaxes(a, 1, 2) / (r_inf * c_1)[:, None, None]

    def mm(x, y, alg):
        return jnp.matmul(x, y, precision=alg,
                          preferred_element_type=jnp.float32)

    def phase(x, alg, tol_phase, iters_left):
        """Iterate while the residual strictly improves and exceeds tol.

        The strict-decrease guard is the divergence safety: in bf16 the
        iteration's error floor is ~eps_bf16·κ(A), and past it quadratic
        error amplification would blow up (NaN for κ ≳ 1e4).  A NaN
        residual also fails the comparison, exiting the loop.

        The loop state carries AX alongside X so that ``res`` is always
        the residual of the CURRENT iterate.  A lagged residual would make
        ``res == prev`` after the first step whenever the start already
        has residual < 1 (e.g. the "spd" init, or a near-identity input),
        falsely tripping the strict-decrease guard.
        """

        def cond(state):
            i, _, _, res, prev = state
            # * the ∞-norm residual of I−AX_{k+1} = (I−AX_k)² may rise
            #   transiently while > 1 (‖M²‖∞ ≤ ‖M‖∞² is the only bound),
            #   so monotonicity is only demanded once res < 1;
            # * at a precision's error floor the residual jitters, breaking
            #   the strict decrease and exiting within a step or two;
            # * genuine divergence (bf16 with κ ≳ 1e4) explodes past the
            #   cap or to NaN — both fail the res < cap compare.
            cap = jnp.float32(1e4)
            making_progress = (res < prev) | (res >= 1.0)
            return ((i < iters_left) & (res > tol_phase)
                    & (res < cap) & making_progress)

        def body(state):
            i, x, ax, res, _ = state
            xn = mm(x, 2.0 * eye - ax, alg)
            axn = mm(a, xn, alg)
            return i + 1, xn, axn, _residual_inf(eye, axn), res

        ax0 = mm(a, x, alg)
        res0 = _residual_inf(eye, ax0)
        i, x, ax, res, prev = jax.lax.while_loop(
            cond, body, (0, x, ax0, res0, jnp.float32(jnp.inf)))
        return x, res

    # Phase 1: cheap bf16 contraction.
    x, res = phase(x0, BF16, jnp.float32(tol), max_iters)
    # Divergence fallback: if bf16 failed to contract below 1 (plateaued,
    # exploded to a large-but-finite residual, or NaN — all fail res < 1),
    # restart the fp32 phase from x0, whose spectral residual is < 1 by
    # construction.
    bad = ~(res < 1.0)
    x = jnp.where(bad, x0, x)
    # Phase 2: fp32 continuation — handles ill-conditioned batches where
    # bf16 cannot contract (err floor eps_bf16·κ ≥ 1).
    x, _ = phase(x, F32, jnp.float32(0.0), max_iters)

    for _ in range(polish_iters):
        # full-fp32 polish on purpose: this path is the κ ≲ 1e4
        # robustness backstop; the residual-form polish of the fixed lanes
        # carries a 2⁻⁹·κ·‖R‖ bf16 term that can exceed ‖R‖² at large κ.
        x = mm(x, 2.0 * eye - mm(a, x, F32), F32)
    return x.astype(orig_dtype)


def scaled_round_coeffs(mu_min: float, rounds: int,
                        noise_floor: float = 5e-3):
    """Per-round scalars for SCALED Newton–Schulz (Chen–Chow-style).

    Plain NS contracts the residual radius r → r²; for r = 1−ε near 1
    that's ε → 2ε, one bit per round.  Rescaling the iterate so the
    spectrum of AX is recentered on 1 — X̃ = cX with c = 2/(lo+hi) —
    doubles the *relative* gap instead (ε → ~4ε), nearly halving the
    bf16 round count at the κ=30 domain edge.  The scalar folds into the
    round's existing elementwise pass (tmp = 2c·I − c²·AX), so each
    scaled round costs exactly the same as an unscaled one.

    The interval [lo, 1] ⊇ spec(AX) evolves deterministically from the
    ``mu_min`` assumption, so the c-sequence is a compile-time constant.

    ``noise_floor`` — the bf16 safety clamp: full recentering maps an
    eigenvalue sitting at the TOP of the assumed interval to exactly the
    new bottom edge 4·lo/(1+lo)², and when that edge is below the bf16
    round noise (~2⁻⁹), noise flips such eigenvalues NEGATIVE and the
    iteration amplifies them ~4× per round → divergence.  Near-identity
    matrices (the diagonally-dominant reference fixtures) have their whole
    spectrum at the interval top.  Clamping the assumed bottom at
    ``noise_floor`` keeps the squashed edge ≥ 4·floor/(1+floor)² ≈ 0.02,
    ten times the noise; eigenvalues truly below the clamp still grow
    ~2c ≈ 4× per round (vs 2× unscaled), so the round count barely moves.
    """
    t = mu_min  # tracked true lower edge
    cs = []
    for _ in range(rounds):
        c = 2.0 / (1.0 + max(t, noise_floor))
        cs.append(c)
        t = min(1.0, c * t * (2.0 - c * t))
    return tuple(cs)


# ---------------------------------------------------------------------------
# Fixed schedule: one per-matrix computation, run by the Triton kernel or
# by XLA under vmap
# ---------------------------------------------------------------------------

def _mm(x, y, alg):
    return jnp.matmul(x, y, precision=alg, preferred_element_type=jnp.float32)


def _eye(n):
    return (lax.broadcasted_iota(jnp.int32, (n, n), 0)
            == lax.broadcasted_iota(jnp.int32, (n, n), 1)).astype(jnp.float32)


def _ns_start(a, init):
    """X₁ = 2sI − s²A, s = 1/‖A‖∞ (spd) or X₀ = Aᵀ/(‖A‖₁‖A‖∞) (pan) for
    one (n, n) float32 matrix."""
    r_inf = jnp.max(jnp.sum(jnp.abs(a), axis=1))
    if init == "spd":
        s = 1.0 / r_inf
        return (2.0 * s) * _eye(a.shape[-1]) - (s * s) * a
    c_1 = jnp.max(jnp.sum(jnp.abs(a), axis=0))
    return a.T * (1.0 / (r_inf * c_1))


def _ns_rounds(a, x, lo_iters, hi_iters, scales, split3, polish_highest):
    """The fixed rounds on one (n, n) float32 matrix, starting from ``x``.

    ``lo_iters`` contraction rounds X ← cX(2I − cAX) (c from ``scales``,
    1 when ``scales`` is None — warm starts are already converged and a
    cold-start recentering scalar would blow them apart), then
    ``hi_iters`` polish rounds in residual form X ← X + X·R, R = I − AX.

    Products: contraction at ``BF16`` (``BF16_X3`` for split3).  Polish:
    R is fp32-class (``BF16_X6``) in the last round; earlier bf16-lane
    rounds only have to beat the few-e-2 residual arriving from the
    contraction and take R at ``BF16_X3``; ``polish_highest=False`` (the
    κ ≲ 10 lane) takes every R at ``BF16_X3``.  The X·R update is one
    bf16 pass (``BF16_X3`` for split3): its 2⁻⁹·κ·‖R‖ error is why the
    bf16 lanes are confined to κ ≲ 30.  split3 computes every R at
    ``BF16_X6`` — its 3-pass probe's 2⁻¹⁷·κ error is the size of the
    arriving residual at κ = 500.
    """
    eye = _eye(a.shape[-1])
    contract = BF16_X3 if split3 else BF16
    for i in range(lo_iters):
        c = 1.0 if scales is None else float(scales[i])
        x = _mm(x, (2.0 * c) * eye - (c * c) * _mm(a, x, contract), contract)
    for i in range(hi_iters):
        final = i == hi_iters - 1 and polish_highest
        r_alg = BF16_X6 if (split3 or final) else BF16_X3
        r = eye - _mm(a, x, r_alg)
        x = x + _mm(x, r, contract)
    return x


def _cold_core(init, lo_iters, hi_iters, mu_min, split3, polish_highest):
    """The per-matrix cold computation a → A⁻¹ with its schedule bound."""
    if mu_min is None:
        mu_min = (MU_MIN_PAN500 if split3
                  else MU_MIN_SPD if init == "spd" else MU_MIN_PAN)
    scales = scaled_round_coeffs(
        mu_min, lo_iters,
        noise_floor=SPLIT3_NOISE_FLOOR if split3 else 5e-3)

    def core(a):
        return _ns_rounds(a, _ns_start(a, init), lo_iters, hi_iters, scales,
                          split3, polish_highest)

    return core


def _warm_core(lo_iters, hi_iters, split3):
    def core(a, x0):
        return _ns_rounds(a, x0, lo_iters, hi_iters, None, split3, True)

    return core


def _check_lane(init, precision, polish_highest):
    if init not in ("pan", "spd"):
        raise ValueError(f"init must be 'pan' or 'spd', got {init!r}")
    if precision not in ("bf16", "split3"):
        raise ValueError(
            f"precision must be 'bf16' or 'split3', got {precision!r}")
    split3 = precision == "split3"
    if split3 and not polish_highest:
        # the split3 rounds take EVERY polish residual fp32-class; a
        # polish_highest=False split3 lane would need its own calibration
        raise ValueError("polish_highest=False is not supported with "
                         "precision='split3'")
    if split3 and init != "pan":
        # the split3 schedule is calibrated on the Pan start's µ = 1/κ²
        # interval evolution; an SPD-start split3 lane would need its own
        # mu_min/round calibration
        raise ValueError("precision='split3' supports init='pan' only")
    schedule = (PAN500_SCHEDULE if split3
                else SPD_SCHEDULE if init == "spd" else PAN_SCHEDULE)
    return split3, schedule


def _f64_route(a, split3):
    if split3:
        # the request is served by a DIFFERENT algorithm — adaptive f64
        # NS (→ f64 LU), which natively beats the 2⁻¹⁷ split floor
        warnings.warn(
            "precision='split3' with float64 input: serving via the "
            "adaptive f64 Newton-Schulz path (f64 arithmetic already "
            "exceeds the split-precision floor)", stacklevel=3)
    return inverse_newton_schulz(a)


@functools.partial(jax.jit, static_argnames=("lo_iters", "hi_iters", "init",
                                             "polish_highest", "mu_min",
                                             "precision"))
def inverse_newton_schulz_fixed(
    a: jnp.ndarray,
    lo_iters: int | None = None,
    hi_iters: int | None = None,
    init: str = "pan",
    polish_highest: bool = True,
    mu_min: float | None = None,
    precision: str = "bf16",
) -> jnp.ndarray:
    """Fixed-schedule Newton–Schulz in plain XLA: the per-matrix
    computation of :func:`inverse_newton_schulz_pallas` under ``vmap``.

    Each round is two batched matrix products and one elementwise
    fusion, with the iterates in device memory between them.  Same
    arguments, schedules and κ domains as the kernel; serves every n.
    """
    split3, schedule = _check_lane(init, precision, polish_highest)
    if a.dtype == jnp.float64:
        return _f64_route(a, split3)
    core = _cold_core(init, schedule[0] if lo_iters is None else lo_iters,
                      schedule[1] if hi_iters is None else hi_iters,
                      mu_min, split3, polish_highest)
    return jax.vmap(core)(a.astype(jnp.float32)).astype(a.dtype)


def _kernel_n(n: int) -> int:
    """Padded kernel width: a power of two (Triton block shapes) and at
    least 16 (the smallest operand a Triton dot takes)."""
    return max(16, 1 << (n - 1).bit_length())


def _pad_scaled_identity(a: jnp.ndarray, m: int, x0=None):
    """blockdiag(A, sI) of width ``m``, s = min(‖A‖₁, ‖A‖∞) per matrix.

    Both norms of the padded matrix are A's own, so the start scalings
    (1/‖A‖∞ for spd, 1/(‖A‖₁‖A‖∞) for pan) are the ones the schedules
    were calibrated on, at any scale of A; and since σ_min(A) ≤ s, the
    pad block's start eigenvalue lies inside A's own interval.  Its
    inverse blockdiag(A⁻¹, I/s) slices back exactly.  With ``x0`` (a
    warm start) also returns blockdiag(X₀, I/s).
    """
    n = a.shape[-1]
    if m == n:
        return a if x0 is None else (a, x0)
    s = jnp.minimum(jnp.max(jnp.sum(jnp.abs(a), axis=-1), axis=-1),
                    jnp.max(jnp.sum(jnp.abs(a), axis=-2), axis=-1))
    s = jnp.where(s > 0, s, 1.0)[..., None, None]
    eye = jnp.eye(m - n, dtype=a.dtype)

    def pad(x, block):
        out = jnp.zeros(x.shape[:-2] + (m, m), x.dtype)
        return out.at[..., :n, :n].set(x).at[..., n:, n:].set(block)

    if x0 is None:
        return pad(a, s * eye)
    return pad(a, s * eye), pad(x0, eye / s)


def _interpret(interpret: bool | None) -> bool:
    if interpret is not None:
        return interpret
    return os.environ.get(INTERPRET_ENV) == "1"


#: warps per program by padded width (one program is one matrix), the
#: fastest at a 10 000-matrix batch on an H100 (PERF.md)
_NUM_WARPS = {16: 4, 32: 2, 64: 4, 128: 8}


def _per_matrix_call(core, operands, interpret: bool, name: str):
    """Run ``core`` (n×n float32 matrices → n×n) as one Triton program per
    matrix of the batch.  Operands are (batch, m, m) float32 with m a
    kernel width."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as pl_triton

    batch, m, _ = operands[0].shape
    if batch == 0:
        return jnp.zeros((0, m, m), jnp.float32)
    spec = pl.BlockSpec((None, m, m), lambda i: (i, 0, 0))

    def kernel(*refs):
        *in_refs, out_ref = refs
        out_ref[...] = core(*(r[...] for r in in_refs))

    return pl.pallas_call(
        kernel,
        grid=(batch,),
        in_specs=[spec] * len(operands),
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((batch, m, m), jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=_NUM_WARPS[m],
                                                 num_stages=1),
        interpret=interpret,
        name=name,
    )(*operands)


@functools.partial(jax.jit, static_argnames=("lo_iters", "hi_iters",
                                             "interpret", "init",
                                             "polish_highest", "mu_min",
                                             "precision"))
def inverse_newton_schulz_pallas(
    a: jnp.ndarray,
    lo_iters: int | None = None,
    hi_iters: int | None = None,
    interpret: bool | None = None,
    init: str = "pan",
    polish_highest: bool = True,
    mu_min: float | None = None,
    precision: str = "bf16",
) -> jnp.ndarray:
    """Fixed-iteration Newton–Schulz, one Triton program per matrix.

    Each program reads its A once, keeps X and every round's product on
    chip, and writes X once; the plain-XLA form of the same schedule
    (:func:`inverse_newton_schulz_fixed`) moves the iterates through
    device memory twice per round.  n pads to a power of two ≥ 16 with
    a scaled identity block; n > ``KERNEL_MAX_N`` runs the XLA form.

    DOMAIN (default schedules, κ in the 2-norm on geomspace-spectrum test
    batches; ``chip_smoke.py`` re-checks each edge on the GPU):

    * ``init="pan"`` (any nonsingular A), lo=12 hi=2: κ(A) ≲ 30, and
      the κ≈100 nonsymmetric edge case of ``chip_smoke.py``.
    * ``init="spd"`` (SPD A only — caller-asserted, like the Cholesky
      paths), lo=6 hi=2: κ(A) ≲ 30 at ~half the pan work, because the
      SPD start X₀ = I/‖A‖∞ contracts at 1 − 1/κ instead of 1 − 1/κ² and
      its first round folds into elementwise setup.
    * ``precision="split3"`` (pan only), lo=14 hi=2: κ(A) ≲ 500 for any
      nonsingular matrix — every product runs the 3-pass bf16 split.

    Beyond that the bf16 floor (≈ eps_bf16·κ) exceeds what the polish can
    recover; use :func:`inverse_newton_schulz` (adaptive) or the
    factorization lanes.  f64 runs the adaptive path (→ f64 LU).
    """
    split3, schedule = _check_lane(init, precision, polish_highest)
    if a.dtype == jnp.float64:
        return _f64_route(a, split3)
    lo_iters = schedule[0] if lo_iters is None else lo_iters
    hi_iters = schedule[1] if hi_iters is None else hi_iters
    n = a.shape[-1]
    if n > KERNEL_MAX_N:
        return inverse_newton_schulz_fixed(
            a, lo_iters=lo_iters, hi_iters=hi_iters, init=init,
            polish_highest=polish_highest, mu_min=mu_min,
            precision=precision)
    core = _cold_core(init, lo_iters, hi_iters, mu_min, split3,
                      polish_highest)
    a32 = _pad_scaled_identity(a.astype(jnp.float32), _kernel_n(n))
    out = _per_matrix_call(core, (a32,), _interpret(interpret),
                           "newton_schulz_inverse")
    return out[:, :n, :n].astype(a.dtype)


@functools.partial(jax.jit, static_argnames=("lo_iters", "hi_iters",
                                             "interpret", "precision"))
def inverse_newton_schulz_warm(
    a: jnp.ndarray,
    x0: jnp.ndarray,
    lo_iters: int = 2,
    hi_iters: int = 1,
    interpret: bool | None = None,
    precision: str = "bf16",
) -> jnp.ndarray:
    """Warm-start batched inversion: refine a previous inverse ``x0`` of a
    slowly-varying batch.

    The serving pattern the reference's sensor workload implies
    (``README.md:41-44``) but never built: when A changes by a relative
    perturbation δ between requests, the old inverse has residual
    ‖I − A'X‖ ≈ δ·κ(A), so the default 2 bf16 + 1 polish rounds recover
    the 1e-4 gate whenever δ·κ ≲ 0.3, with the additional bf16 bound
    κ ≲ 30 (the one-pass X·R update carries 2⁻⁹·κ·‖R‖).
    ``precision="split3"`` lifts the κ bound to κ ≲ 500 by running every
    product as the 3-pass split.  n ≤ ``KERNEL_MAX_N`` runs one Triton
    program per matrix; larger n the same rounds in plain XLA.  f64 runs
    a cold adaptive solve.
    """
    if precision not in ("bf16", "split3"):
        raise ValueError(
            f"precision must be 'bf16' or 'split3', got {precision!r}")
    if a.dtype == jnp.float64:
        return inverse_newton_schulz(a)
    core = _warm_core(lo_iters, hi_iters, precision == "split3")
    a32, x32 = a.astype(jnp.float32), x0.astype(jnp.float32)
    n = a.shape[-1]
    if n > KERNEL_MAX_N:
        return jax.vmap(core)(a32, x32).astype(a.dtype)
    out = _per_matrix_call(core, _pad_scaled_identity(a32, _kernel_n(n), x32),
                           _interpret(interpret), "newton_schulz_warm")
    return out[:, :n, :n].astype(a.dtype)
