"""Headline benchmark: 100× 128×128 fp32 batched inversion on one device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "detail"}.

Every device lane of the registry (the adaptive Newton–Schulz pair aside:
its while-loop reads a predicate on the host each round and the fixed
lanes dominate it) is gated first — max ‖AA⁻¹−I‖∞ < 1e-4 in fp32 — and
each lane that passes is timed as the median of synchronized calls on a
device-resident batch (``block_until_ready`` waits for the device).  The
fastest passing lane is the headline.

Baseline (BASELINE.md §1): the reference's best GPU path — cuBLAS batched
LU on a GTX 690 — inverts 100× 128×128 in 14.079 ms ≈ 7,103 inversions/s
(transfers included over ~12 GB/s PCIe).  Here batches are
device-resident per the BASELINE.json north star.

``detail.roofline_floor_ms`` is the least time the device could take to
read A and write A⁻¹ at its published memory bandwidth, for a device in
``MEMORY_BYTES_PER_S``; for any other device it is null.

The benchmark refuses to run where JAX finds no accelerator.
"""

import json
import subprocess
import sys
import time

import numpy as np

BASELINE_MS = 14.079  # reference cuBLAS LU, GTX 690
METRIC = "batched_inversions_per_sec_100x128x128_fp32"
GATE = 1e-4
EXCLUDE = frozenset({"newton_schulz", "newton_schulz_spd"})

#: Published device-memory bandwidth by ``device_kind`` (NVIDIA H100
#: data sheet: SXM 3.35 TB/s, PCIe 2.0 TB/s).
MEMORY_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def roofline_floor_ms(nbytes: int, device_kind: str):
    """Read A + write A⁻¹ at the published bandwidth; None if unknown."""
    bw = MEMORY_BYTES_PER_S.get(device_kind)
    return None if bw is None else 2 * nbytes / bw * 1e3


def synced_ms(fn, x, reps: int = 30):
    """Per-call milliseconds of ``fn(x)`` over ``reps`` synchronized calls
    after one warm call."""
    import jax

    jax.block_until_ready(fn(x))
    out = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(x))
        out.append((time.perf_counter() - t) * 1e3)
    return out


def headline(lanes: dict, device: dict, nbytes: int) -> dict:
    """The JSON line from ``{name: {"ms": [...], "err": float}}``; the
    fastest gate-passing lane by median wins."""
    summary = {k: {"median_ms": float(np.median(v["ms"])) if v["ms"] else None,
                   "err": v["err"]} for k, v in lanes.items()}
    passing = {k: v for k, v in lanes.items() if v["err"] < GATE}
    if not passing:
        return {"metric": METRIC, "value": 0.0, "unit": "inversions/s",
                "vs_baseline": 0.0,
                "detail": {"note": "no algorithm passed the 1e-4 gate",
                           "device": device, "lanes": summary}}
    med = {k: float(np.median(v["ms"])) for k, v in passing.items()}
    best = min(med, key=med.get)
    ms = np.asarray(passing[best]["ms"])
    per_sec = 100.0 / (med[best] / 1e3)
    return {
        "metric": METRIC,
        "value": per_sec,
        "unit": "inversions/s",
        "vs_baseline": per_sec / (100.0 / (BASELINE_MS / 1e3)),
        "detail": {
            "algorithm": best,
            "batch_ms": med[best],
            "batch_ms_p25_p75": [float(np.percentile(ms, 25)),
                                 float(np.percentile(ms, 75))],
            "reps": int(ms.size),
            "gate_err": passing[best]["err"],
            "roofline_floor_ms": roofline_floor_ms(nbytes, device["kind"]),
            "device": device,
            "lanes": summary,
        },
    }


def main() -> int:
    from cuda_matrix_inversion_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform == "cpu":
        print("bench.py: no accelerator found (JAX platform is cpu)",
              file=sys.stderr)
        return 2
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        smi = "nvidia-smi unavailable"
    print(f"bench: {smi}", file=sys.stderr)

    from cuda_matrix_inversion_tpu.bench.reporting import identity_error_inf
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops.registry import (
        get_inverse_algorithm,
        list_inverse_algorithms,
    )

    a = make_spd_batch(100, 128, np.random.default_rng(2026)).astype(np.float32)
    a_dev = jax.device_put(a)
    lanes = {}
    for name in list_inverse_algorithms(cpu=False):
        if name in EXCLUDE:
            continue
        fn = jax.jit(get_inverse_algorithm(name))
        err = identity_error_inf(a, np.asarray(jax.device_get(fn(a_dev))))
        lanes[name] = {"ms": synced_ms(fn, a_dev) if err < GATE else [],
                       "err": err}
        print(f"bench: {name} err={err:.3e} ms={lanes[name]['ms'][:3]}...",
              file=sys.stderr)
    line = headline(lanes, device, a.nbytes)
    print(json.dumps(line), flush=True)
    return 0 if line["value"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
