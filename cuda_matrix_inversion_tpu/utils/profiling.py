"""Profiling/tracing: jax.profiler capture + phase-stage CSV logging.

Reference counterparts (SURVEY §5 "Tracing/profiling"):

* the ``-DDETAILED_LOGGING`` build bracketing every pipeline stage with
  ``TIMER_START/STOP`` + ``TIMER_LOG`` CSV lines (``include/timer.h:8-9``,
  usage ``src/gauss_bench.cu:150-256``) → :class:`StageLogger`, emitting
  the identical ``name,numMatrices,n,ms,ns`` schema;
* the checked-in nvprof traces (``summary_trace_gauss.txt`` etc.) →
  :func:`trace` writing a TensorBoard/Perfetto trace via ``jax.profiler``.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import shutil
import sys
import tempfile
from typing import Optional, TextIO

from cuda_matrix_inversion_tpu.utils.timer import Timer


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, create: bool = True):
    """Capture a device profile around a code block (nvprof analog).

    View with TensorBoard's profile plugin or Perfetto.
    """
    import jax

    logdir = logdir or os.path.join(tempfile.gettempdir(), "cmi_trace")
    if create:
        os.makedirs(logdir, exist_ok=True)
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


class StageLogger:
    """DETAILED_LOGGING-style per-stage CSV logger.

    Usage::

        log = StageLogger(num_matrices=100, n=128)
        with log.stage("calculate_mean_gpu_inv", block_on=lambda: out):
            out = inv_fn(k)
    """

    def __init__(self, num_matrices: int, n: int, stream: Optional[TextIO] = None):
        self.num_matrices = num_matrices
        self.n = n
        self.stream = stream or sys.stdout
        self.timers: dict[str, Timer] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t = self.timers.setdefault(name, Timer(name))
        t.start()
        holder = _BlockHolder()
        try:
            yield holder
        finally:
            t.stop(*holder.arrays)
            t.log(self.num_matrices, self.n, self.stream)


class _BlockHolder:
    """Collects device arrays the stage should synchronize on."""

    def __init__(self):
        self.arrays = []

    def block_on(self, *arrays):
        self.arrays.extend(arrays)
        return arrays[0] if len(arrays) == 1 else arrays


_HOST_EVENT_MARKERS = (
    "$", ".py", "PjitFunction", "PJRT", "ParseArguments",
    "PythonRefManager", "jit_", "trace", "__enter__", "__exit__",
)


def _device_events(thunk, logdir: Optional[str]):
    """Run ``thunk`` under a trace; return its device events as
    ``(ts_us, dur_us, name)``.

    On a GPU the Perfetto JSON names one process per device
    (``/device:GPU:N``): its events are the kernels.  Where the trace has
    no device process (the CPU backend runs ops on host threads), host
    events are dropped by name instead.
    """
    cleanup = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="cmi_prof_")
    events = []
    try:
        with trace(logdir):
            thunk()
        for path in glob.glob(
                os.path.join(logdir, "plugins", "profile", "*",
                             "*.trace.json.gz")):
            with gzip.open(path) as f:
                raw = json.load(f).get("traceEvents", [])
            gpu_pids = {e.get("pid") for e in raw
                        if e.get("ph") == "M" and e.get("name") == "process_name"
                        and "/device:GPU" in str(e.get("args", {}).get("name"))}
            for e in raw:
                name = e.get("name", "")
                if e.get("ph") != "X" or not name:
                    continue
                if gpu_pids:
                    if e.get("pid") not in gpu_pids:
                        continue
                elif any(m in name for m in _HOST_EVENT_MARKERS):
                    continue
                events.append((float(e.get("ts", 0.0)),
                               float(e.get("dur", 0.0)), name))
    finally:
        if cleanup:
            shutil.rmtree(logdir, ignore_errors=True)
    return events


def profile_summary(thunk, logdir: Optional[str] = None, top: int = 15):
    """Run ``thunk`` under a device trace and aggregate op time.

    The analog of the reference's checked-in nvprof summaries
    (``summary_trace_gauss.txt:4-11`` — kernel name, share of GPU time,
    calls, avg): parses the Perfetto JSON that ``jax.profiler`` writes,
    keeps the device events, and returns rows of
    ``(name, total_us, calls, share)`` sorted by total time.
    """
    durs: dict[str, tuple[float, int]] = {}
    for _, dur, name in _device_events(thunk, logdir):
        d, c = durs.get(name, (0.0, 0))
        durs[name] = (d + dur, c + 1)
    total = sum(d for d, _ in durs.values()) or 1.0
    rows = [(name, d, c, d / total)
            for name, (d, c) in sorted(durs.items(), key=lambda kv: -kv[1][0])]
    return rows[:top]


def format_profile_summary(rows) -> str:
    """Render :func:`profile_summary` rows in the nvprof-summary style."""
    lines = [f"{'time_share':>10} {'total_us':>12} {'calls':>6}  name"]
    for name, dur, calls, share in rows:
        lines.append(f"{share:>9.1%} {dur:>12.1f} {calls:>6d}  {name}")
    return "\n".join(lines)


def timeline(thunk, logdir: Optional[str] = None, max_events: int = 200):
    """Run ``thunk`` under a device trace and return the chronological
    per-launch timeline — the analog of the reference's per-launch nvprof
    dump (``gpu_trace_gauss.txt:3-25``, which exposed its per-column
    iamax→D2H→scal→transform launch storm).  Rows:
    ``(start_us, dur_us, name)`` relative to the first device event.

    ``logdir=None`` uses a temp dir; pass a real dir to ALSO keep the
    raw Perfetto ``*.trace.json.gz`` for interactive inspection
    (load in Perfetto/TensorBoard-profile).
    """
    events = sorted(_device_events(thunk, logdir))
    if not events:
        return []
    t0 = events[0][0]
    return [(ts - t0, dur, name) for ts, dur, name in events[:max_events]]


def format_timeline(rows) -> str:
    """Render :func:`timeline` rows gpu_trace-style."""
    lines = [f"{'start_us':>12} {'dur_us':>10}  name"]
    for ts, dur, name in rows:
        lines.append(f"{ts:>12.2f} {dur:>10.2f}  {name}")
    return "\n".join(lines)


def _main(argv=None) -> int:
    """CLI: profile the flagship paths and print nvprof-style summaries.

    ``python -m cuda_matrix_inversion_tpu.utils.profiling [--out FILE]``
    """
    import argparse

    import numpy as np

    p = argparse.ArgumentParser(description="device profile summary (nvprof analog)")
    p.add_argument("--out", default=None, help="write the summary here")
    p.add_argument("--timeline-out", default=None,
                   help="also write a per-launch timeline (gpu_trace analog)")
    p.add_argument("--trace-dir", default=None,
                   help="keep the raw Perfetto trace under this directory")
    p.add_argument("--batch", type=int, default=100)
    p.add_argument("--n", type=int, default=128)
    args = p.parse_args(argv)

    import jax

    from cuda_matrix_inversion_tpu.io.fixtures import make_spd_batch
    from cuda_matrix_inversion_tpu.models.gp import gp_mean_variance
    from cuda_matrix_inversion_tpu.ops.registry import get_inverse_algorithm

    rng = np.random.default_rng(0)
    b = make_spd_batch(args.batch, args.n, rng).astype(np.float32)
    vec = lambda: rng.random((args.batch, args.n, 1), dtype=np.float32)  # noqa: E731
    a, c, d = vec(), vec(), vec()
    e = rng.random((args.batch, 1, 1), dtype=np.float32)

    inv_fn = jax.jit(get_inverse_algorithm("newton_schulz_spd_pallas"))
    gp_fn = jax.jit(lambda *xs: gp_mean_variance(*xs, method="solve"))
    # stage inputs on the device so the trace shows kernels, not transfers
    bd = jax.device_put(b)
    gp_args = [jax.device_put(x) for x in (a, b, c, d, e)]
    inv_fn(bd).block_until_ready()  # compile outside the trace
    jax.block_until_ready(gp_fn(*gp_args))

    out_lines = []
    tl_lines = []
    for i, (title, thunk) in enumerate((
        (f"batched inversion newton_schulz_spd_pallas {args.batch}x{args.n}x{args.n}",
         lambda: inv_fn(bd).block_until_ready()),
        (f"GP mean/variance solve {args.batch}x{args.n}",
         lambda: jax.block_until_ready(gp_fn(*gp_args))),
    )):
        rows = profile_summary(thunk)
        out_lines.append(f"== {title} ==")
        out_lines.append(format_profile_summary(rows))
        out_lines.append("")
        if args.timeline_out or args.trace_dir:
            tdir = (os.path.join(args.trace_dir, f"run{i}")
                    if args.trace_dir else None)
            trows = timeline(thunk, logdir=tdir)
            tl_lines.append(f"== {title} ==")
            tl_lines.append(format_timeline(trows))
            tl_lines.append("")
    text = "\n".join(out_lines)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    if args.timeline_out:
        with open(args.timeline_out, "w") as f:
            f.write("\n".join(tl_lines))
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
