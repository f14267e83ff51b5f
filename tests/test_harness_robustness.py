"""Round-3 harness-robustness surfaces (VERDICT r2 weak #1-#4).

Covers: loud failure on unknown algorithm names + comma lists
(``inverse_bench.resolve_algorithms``), the sweep-CSV outlier audit
(``reporting.audit_outliers``), the backend pin (``utils.backend``), and
bench.py's choice of headline lane.
"""

import json
import os

import pytest

from cuda_matrix_inversion_tpu.bench.inverse_bench import (
    OPTIONAL_ALGORITHMS,
    resolve_algorithms,
)
from cuda_matrix_inversion_tpu.bench.reporting import (
    audit_outliers,
    parse_csv_rows,
)
from cuda_matrix_inversion_tpu.utils.errors import EnsureError

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- resolve_algorithms (weak #2: the silent empty benchmark) ---------

def test_resolve_splits_comma_lists():
    avail = {"lu", "lu_cpu", "gauss_cpu"}
    assert resolve_algorithms(["lu_cpu,lu", "gauss_cpu"], avail) == [
        "lu_cpu", "lu", "gauss_cpu"]


def test_resolve_fails_loudly_on_typo():
    with pytest.raises(EnsureError, match="gauss_cppu"):
        resolve_algorithms(["lu_cpu,lu,gauss_cppu"], {"lu", "lu_cpu"})


def test_resolve_silently_skips_only_unbuilt_native_rows():
    # the documented exception: optional C++ oracle rows may be absent
    avail = {"lu"}
    names = ["lu"] + sorted(OPTIONAL_ALGORITHMS)
    assert resolve_algorithms(names, avail) == ["lu"]
    # ...but an unknown NON-optional name among them still fails
    with pytest.raises(EnsureError):
        resolve_algorithms(names + ["nope"], avail)


def test_cli_exits_nonzero_on_unknown_algorithm(tmp_path):
    # the exact reproduction from VERDICT r2 weak #2, now exit 1 + message
    from cuda_matrix_inversion_tpu.bench import inverse_bench

    rc = inverse_bench.main([
        os.path.join(REPO_ROOT, "tests", "hand_fixtures"), "1", "1", "-csv",
        "--backend", "cpu", "--algorithms", "lu_cpu,lu,gauss_cppu"])
    assert rc == 1


# --- audit_outliers (weak #4: the published 10x row) -------------------

def _write_csv(path, rows):
    with open(path, "w") as f:
        for num, n, name, mean in rows:
            total = mean * 10
            f.write(f"{num} {n} 10 {name} {total:e} {mean:e} 1e-3 1e-6\n")


def test_audit_flags_planted_outlier(tmp_path):
    p = tmp_path / "sweep.txt"
    # per-matrix time flat at 1e-3 ms except the planted 200-batch row
    _write_csv(p, [(100, 8, "alg", 0.1), (200, 8, "alg", 4.0),
                   (400, 8, "alg", 0.4), (1600, 8, "alg", 1.6)])
    flags = audit_outliers(str(p), k=3.0)
    assert len(flags) == 1
    assert flags[0]["num_matrices"] == 200 and flags[0]["ratio"] > 10


def test_audit_clean_sweep_not_flagged(tmp_path):
    p = tmp_path / "sweep.txt"
    # realistic: per-matrix time mildly DECREASES with batch (amortization)
    _write_csv(p, [(100, 8, "alg", 0.12), (200, 8, "alg", 0.22),
                   (400, 8, "alg", 0.40), (1600, 8, "alg", 1.55),
                   (100, 8, "other", 0.5), (400, 8, "other", 1.9)])
    assert audit_outliers(str(p), k=3.0) == []


def test_audit_tiny_batch_amortization_not_flagged(tmp_path):
    p = tmp_path / "sweep.txt"
    # square_5_* regime: a 5-matrix launch at ~the same TOTAL time as an
    # 80-matrix one is fixed launch cost amortizing, not host noise —
    # 16x worse per matrix, and legitimate (r3: the per-matrix rule
    # flagged half the square sweep this way)
    _write_csv(p, [(5, 8, "alg", 0.06), (10, 8, "alg", 0.055),
                   (80, 8, "alg", 0.05)])
    assert audit_outliers(str(p), k=3.0) == []
    # ...but a genuinely inflated small-batch row still flags: the
    # 80-matrix sibling bounds ANY smaller batch at its own total time
    _write_csv(p, [(5, 8, "alg", 0.9), (10, 8, "alg", 0.055),
                   (80, 8, "alg", 0.05)])
    flags = audit_outliers(str(p), k=3.0)
    assert [f["num_matrices"] for f in flags] == [5]


def test_audit_groups_by_n_and_skips_singletons(tmp_path):
    p = tmp_path / "sweep.txt"
    # large n is legitimately slower per matrix — must not cross-compare
    _write_csv(p, [(100, 8, "alg", 0.1), (400, 8, "alg", 0.4),
                   (100, 128, "alg", 40.0)])
    assert audit_outliers(str(p), k=3.0) == []


def test_parse_csv_rows_skips_phase_lines(tmp_path):
    p = tmp_path / "mixed.txt"
    with open(p, "w") as f:
        f.write("calculate_mean_gpu_inv,100,128,10.3,10300000\n")  # phase log
        f.write("100 8 10 alg 1.0e+00 1.0e-01 1e-3 1e-6\n")
    rows = parse_csv_rows(str(p))
    assert len(rows) == 1 and rows[0]["mean_ms"] == 0.1


# --- backend pin -------------------------------------------------------

def test_pin_backend_auto_is_noop():
    from cuda_matrix_inversion_tpu.utils.backend import pin_backend

    pin_backend("auto")  # must not touch jax config (tests already pin cpu)
    pin_backend(None)


# --- bench.py: headline lane, roofline, refusal off the accelerator -----

def _load_bench():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_module", os.path.join(REPO_ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_DEVICE = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}


def test_headline_picks_fastest_gate_passing_lane():
    bench = _load_bench()
    lanes = {"slow": {"ms": [2.0, 2.1, 1.9], "err": 1e-6},
             "fast_but_wrong": {"ms": [], "err": 3e-3},
             "fast": {"ms": [0.05, 0.06, 0.04], "err": 2e-6}}
    line = bench.headline(lanes, _DEVICE, nbytes=6_553_600)
    json.dumps(line)  # one JSON line
    assert line["detail"]["algorithm"] == "fast"
    assert line["value"] == pytest.approx(100.0 / 0.05 * 1e3, rel=1e-6)
    assert line["vs_baseline"] > 100
    assert line["detail"]["lanes"]["fast_but_wrong"]["median_ms"] is None
    assert line["detail"]["device"] == _DEVICE


def test_headline_without_passing_lane_is_zero():
    bench = _load_bench()
    line = bench.headline({"x": {"ms": [], "err": 1.0}}, _DEVICE, 1)
    assert line["value"] == 0.0 and "note" in line["detail"]


@pytest.mark.parametrize("kind, floor", [
    ("NVIDIA H100 80GB HBM3", 2 * 6_553_600 / 3.35e12 * 1e3),
    ("Some Unknown Card", None),
])
def test_roofline_floor_known_devices_only(kind, floor):
    bench = _load_bench()
    got = bench.roofline_floor_ms(6_553_600, kind)
    assert got == (pytest.approx(floor) if floor is not None else None)


def test_bench_refuses_cpu(capsys):
    bench = _load_bench()
    assert bench.main() == 2
    assert capsys.readouterr().out == ""


# --- sweep: square kind end-to-end + audit wiring -----------------------

def test_sweep_square_kind_end_to_end(tmp_path):
    from cuda_matrix_inversion_tpu.bench import sweep
    from cuda_matrix_inversion_tpu.io.fixtures import generate_square_fixtures

    root = tmp_path / "fx"
    generate_square_fixtures(str(root / "square_5_8x8"), 8, 5, seed=3)
    out = tmp_path / "square-bench.txt"
    rc = sweep.main(["square", str(root), "--reps", "1", "--dups", "1",
                     "--out", str(out), "--backend", "cpu",
                     "--algorithms", "lu,gauss_cpu"])
    assert rc == 0
    rows = [ln.split() for ln in open(out) if ln.strip()]
    assert {r[3] for r in rows} == {"lu", "gauss_cpu"}
    assert all(float(r[-1]) < 1e-4 for r in rows)  # L1 vs shipped aInv
    assert (tmp_path / "square-bench-errors.txt").exists()
