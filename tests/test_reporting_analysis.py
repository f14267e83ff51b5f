"""Tests for reporting formats, stage logging, plots, sweep, membench."""

import io
import os

import numpy as np
import pytest

from cuda_matrix_inversion_tpu.analysis import plots
from cuda_matrix_inversion_tpu.bench.reporting import BenchReporter, l1_error
from cuda_matrix_inversion_tpu.utils.profiling import StageLogger
from cuda_matrix_inversion_tpu.utils.timer import Timer, WelfordAccumulator


def test_welford_matches_numpy():
    rng = np.random.default_rng(3)
    xs = rng.random(100)
    acc = WelfordAccumulator()
    for x in xs:
        acc.add(float(x))
    assert abs(acc.mean - xs.mean()) < 1e-12
    assert abs(acc.variance - xs.var(ddof=1)) < 1e-12
    assert abs(acc.total - xs.sum()) < 1e-12


def test_timer_log_line_schema():
    t = Timer("means_cpu")
    t.start()
    t.stop()
    line = t.log_line(100, 128)
    parts = line.split(",")
    assert parts[0] == "means_cpu" and parts[1] == "100" and parts[2] == "128"
    assert len(parts) == 5  # name,numMatrices,n,ms,ns — ref timer.h:8-9


def test_bench_reporter_csv_formats():
    buf = io.StringIO()
    rep = BenchReporter(100, 32, 1, csv=True, stream=buf)
    e = rep.entry("lu")
    e.timer.start(); e.timer.stop()
    e.total_error = 0.5
    rep.report("lu")
    parts = buf.getvalue().split()
    assert len(parts) == 6  # reps==1 → 6-column format (inverse_bench.c:59-61)
    assert parts[:4] == ["100", "32", "1", "lu"]

    buf = io.StringIO()
    rep = BenchReporter(100, 32, 3, csv=True, stream=buf)
    e = rep.entry("lu")
    for _ in range(3):
        e.timer.start(); e.timer.stop()
    rep.report("lu")
    assert len(buf.getvalue().split()) == 8  # reps>1 → 8-column format


def test_stage_logger_schema():
    buf = io.StringIO()
    log = StageLogger(100, 16, stream=buf)
    with log.stage("calculate_mean_gpu_add"):
        pass
    line = buf.getvalue().strip()
    assert line.startswith("calculate_mean_gpu_add,100,16,")
    assert len(line.split(",")) == 5


def test_l1_error_matches_reference_semantics():
    x = np.ones((2, 2, 2))
    ref = np.zeros((2, 2, 2))
    # sum of |diff| over everything / num_matrices (inverse_bench.c:49-51)
    assert l1_error(x, ref, 2) == 4.0


def test_parse_and_plot_bench_rows(tmp_path):
    p = tmp_path / "bench.txt"
    p.write_text(
        "100 8 1 lu 1.0e+00 1.0e-06\n"
        "100 16 1 lu 2.0e+00 1.0e-06\n"
        "100 8 1 chol 3.0e+00 1.0e-06\n"
        "200 8 3 lu 2.5e+00 8.0e-01 1.0e-02 1.0e-06\n"
    )
    rows = plots.parse_bench_file(str(p))
    assert len(rows) == 4
    assert rows[3].mean_ms == 0.8 and rows[3].num_reps == 3
    out1 = plots.plot_runtime_vs_dimension(rows, str(tmp_path / "d.png"), num_matrices=100)
    out2 = plots.plot_runtime_vs_batch(rows, 8, str(tmp_path / "b.png"))
    assert os.path.getsize(out1) > 1000 and os.path.getsize(out2) > 1000


def test_parse_stage_file_and_plot(tmp_path):
    p = tmp_path / "stages.txt"
    p.write_text(
        "calculate_mean_gpu_add,100,128,0.1,98197\n"
        "calculate_mean_gpu_inv,100,128,10.3,10285316\n"
    )
    stages = plots.parse_stage_file(str(p))
    assert set(stages) == {"calculate_mean_gpu_add", "calculate_mean_gpu_inv"}
    out = plots.plot_stage_split(stages, str(tmp_path / "s.png"))
    assert os.path.getsize(out) > 1000


def test_sweep_cli(fixture_root, tmp_path, capsys):
    from cuda_matrix_inversion_tpu.bench import sweep

    out = tmp_path / "rows.txt"
    rc = sweep.main([
        "inverse", fixture_root, "--reps", "1", "--max-dups", "2",
        "--algorithms", "lu", "--out", str(out),
    ])
    assert rc == 0
    rows = plots.parse_bench_file(str(out))
    # 2 dims (8, 16) x 2 dup levels x 1 algorithm
    assert len(rows) == 4
    assert {r.n for r in rows} == {8, 16}


def test_sweep_resumable_chunks_and_errors_companion(fixture_root, tmp_path):
    # --progress/--budget-s: the bounded-chunk mode; --budget-s 0
    # completes zero configs and exits 3, then a full-budget rerun picks
    # up where the progress file left off, skipping completed configs.
    from cuda_matrix_inversion_tpu.bench import sweep

    out = tmp_path / "rows.txt"
    prog = tmp_path / "progress.txt"
    base = ["inverse", fixture_root, "--reps", "1", "--max-dups", "2",
            "--algorithms", "lu", "--out", str(out),
            "--progress", str(prog)]
    assert sweep.main(base + ["--budget-s", "0"]) == 3
    assert not out.read_text()
    assert sweep.main(base) == 0
    rows = plots.parse_bench_file(str(out))
    assert len(rows) == 4  # 2 dims x 2 dups x 1 algorithm
    assert len(prog.read_text().split()) == 4
    # rerun with everything recorded: no duplicate rows appended
    assert sweep.main(base) == 0
    assert len(plots.parse_bench_file(str(out))) == 4
    # the reference's separate errors-file convention ships alongside
    comp = tmp_path / "rows-errors.txt"
    assert comp.exists()
    lines = [ln.split() for ln in comp.read_text().splitlines()]
    assert len(lines) == 4 and all(len(p) == 6 for p in lines)


def test_sweep_fresh_start_truncates_stale_table(fixture_root, tmp_path):
    # Regression (r3 code-review): re-sweeping with a deleted progress
    # file but an existing output table APPENDED a second full pass —
    # every (config, algorithm) doubled and the outlier audit flagged
    # stale rows against their fresh duplicates.  A fresh start (no
    # completed configs in progress) must truncate the table first;
    # resumed runs keep appending.
    from cuda_matrix_inversion_tpu.bench import sweep

    out = tmp_path / "rows.txt"
    prog = tmp_path / "progress.txt"
    base = ["inverse", fixture_root, "--reps", "1", "--max-dups", "2",
            "--algorithms", "lu", "--out", str(out)]
    assert sweep.main(base + ["--progress", str(prog)]) == 0
    n_rows = len(plots.parse_bench_file(str(out)))
    assert n_rows == 4
    # progress deleted (the r3 incident): rerun must NOT duplicate rows
    prog.unlink()
    assert sweep.main(base + ["--progress", str(prog)]) == 0
    assert len(plots.parse_bench_file(str(out))) == n_rows
    # no progress file at all: each run is a fresh start, same guarantee
    assert sweep.main(base) == 0
    assert len(plots.parse_bench_file(str(out))) == n_rows


def test_sweep_refuses_empty_table_with_complete_progress(fixture_root,
                                                          tmp_path, capsys):
    # Regression (r3): a complete progress file + an externally truncated
    # output table must fail loudly, NOT audit the empty table and wipe
    # the -errors/-outliers companions (this once silently emptied a
    # sweep table when a driver re-entered a sweep whose progress file
    # came from a manual run).
    from cuda_matrix_inversion_tpu.bench import sweep

    out = tmp_path / "rows.txt"
    prog = tmp_path / "progress.txt"
    base = ["inverse", fixture_root, "--reps", "1", "--max-dups", "2",
            "--algorithms", "lu", "--out", str(out),
            "--progress", str(prog)]
    assert sweep.main(base) == 0
    comp = tmp_path / "rows-errors.txt"
    assert comp.exists() and comp.read_text()
    out.write_text("")  # external truncation (a caller's fresh start)
    assert sweep.main(base) == 1
    assert "refusing to audit" in capsys.readouterr().err
    assert comp.read_text()  # companions untouched


def test_membench_runs():
    from cuda_matrix_inversion_tpu.bench import membench

    buf = io.StringIO()
    res = membench.run(num_reps=2, num_elems=1024, num_arrays=2, stream=buf)
    assert res["h2d_GBps"] > 0 and res["hbm_copy_GBps"] > 0


def test_sweep_cli_gauss_branch(fixture_root, tmp_path):
    from cuda_matrix_inversion_tpu.bench import sweep

    out = tmp_path / "gauss_rows.txt"
    rc = sweep.main([
        "gauss", fixture_root, "--reps", "1", "--dups", "1",
        "--method", "lu", "--out", str(out),
    ])
    assert rc == 0
    rows = plots.parse_bench_file(str(out))
    # 2 dims x 4 timer rows (means/variances x cpu/gpu)
    assert len(rows) == 8
    names = {r.name for r in rows}
    assert names == {"means_cpu", "variances_cpu", "means_gpu", "variances_gpu"}


def test_profile_summary_parses_device_events(rng):
    # the nvprof-summary analog must aggregate device ops and drop host
    # events; runs on the CPU backend (jax.profiler works there too)
    import jax
    import jax.numpy as jnp

    from cuda_matrix_inversion_tpu.utils.profiling import (
        format_profile_summary,
        profile_summary,
    )

    x = jnp.asarray(rng.standard_normal((4, 32, 32)).astype(np.float32))
    f = jax.jit(lambda a: jnp.matmul(a, a))
    f(x).block_until_ready()
    rows = profile_summary(lambda: f(x).block_until_ready())
    assert rows, "no device events captured"
    for name, dur, calls, share in rows:
        assert ".py" not in name and not name.startswith("$")
        assert dur >= 0 and calls >= 1 and 0 <= share <= 1
    text = format_profile_summary(rows)
    assert "time_share" in text


def test_registry_spd_adaptive_entry(rng):
    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    a = make_spd_batch(3, 16, rng).astype(np.float32)
    inv = np.asarray(get_inverse_algorithm("newton_schulz_spd")(a))
    err = np.abs(a.astype(np.float64) @ inv - np.eye(16)).sum(-1).max()
    assert err < 1e-4


def test_format_ms_never_prints_zero_row():
    # VERDICT r3 weak #4: a sub-resolution row once published as
    # "runtime 0.0000 ms" — sub-10 µs values must print at µs resolution
    # and exact zero as below-granularity.
    from cuda_matrix_inversion_tpu.bench.reporting import format_ms

    assert format_ms(0.0) == "<timer-granularity"
    assert format_ms(0.0031) == "3.1000 us"
    assert format_ms(1.2345) == "1.2345 ms"
    assert "0.0000 ms" not in format_ms(0.004)


def test_human_report_uses_format_ms():
    import io

    from cuda_matrix_inversion_tpu.bench.reporting import BenchReporter

    buf = io.StringIO()
    rep = BenchReporter(6, 8, 1, csv=False, stream=buf)
    e = rep.entry("lu")
    e.timer.stats.add(2e-9)  # 2 ns wall — below the old 4-decimal ms floor
    e.total_error = 0.0
    rep.report("lu")
    out = buf.getvalue()
    assert "0.0000 ms" not in out
    assert "us" in out or "<timer-granularity" in out
