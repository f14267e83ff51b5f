"""Standalone stdin demos — the reference's teaching programs.

Reference counterparts:

* ``cholesky_cpu`` (``src/inverse_cholesky_cpu.c:88-103``, ``make
  cholesky_cpu`` ``Makefile:229-235``): read an SPD matrix from stdin,
  print its Cholesky factor, the inverted lower triangle, and the full
  inverse.
* the early-prototype stdin matrices ``src/gauss/{31,32,41,51,seq}.txt``
  (first line n, then n² values) and ``batch_3.txt`` (``num m n``
  header) — both formats are accepted here.

Usage::

    python -m cuda_matrix_inversion_tpu.demos cholesky < matrix.txt
    python -m cuda_matrix_inversion_tpu.demos gauss    < matrix.txt

Both demos run on the host: they are teaching tools, and the Gauss–Jordan
demo uses the NumPy oracle (``ops/cpu_reference.inverse_gauss_jordan``),
the reference's pivoting algorithm step for step.  ``--backend`` is
accepted for CLI uniformity.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cuda_matrix_inversion_tpu.utils.printing import print_matrix


def read_stdin_matrices(stream=None) -> np.ndarray:
    """Parse either demo format into a (batch, m, n) array."""
    stream = stream or sys.stdin
    tokens = stream.read().split()
    if not tokens:
        raise ValueError("no input on stdin")
    header = tokens[0:3]
    if len(header) == 3 and all(t.lstrip("-").isdigit() for t in header):
        num, m, n = (int(t) for t in header)
        if num * m * n == len(tokens) - 3:  # batch format: "num m n" header
            vals = np.array(tokens[3:], dtype=np.float64)
            return vals.reshape(num, m, n)
    n = int(tokens[0])
    vals = np.array(tokens[1:1 + n * n], dtype=np.float64)
    if vals.size != n * n:
        raise ValueError(f"expected {n * n} values after header n={n}, got {vals.size}")
    return vals.reshape(1, n, n)


def demo_cholesky(mats: np.ndarray, file=None) -> None:
    """Decompose → invert lower → multiply, printing each stage
    (ref ``inverse_cholesky_cpu.c`` main flow)."""
    file = file or sys.stdout
    for k, a in enumerate(mats):
        print(f"matrix {k}: input", file=file)
        print_matrix(a, file=file)
        l = np.linalg.cholesky(a)
        print("cholesky factor L:", file=file)
        print_matrix(l, file=file)
        w = np.linalg.solve(l, np.eye(a.shape[0]))
        print("L^-1:", file=file)
        print_matrix(w, file=file)
        print("A^-1 = L^-T L^-1:", file=file)
        print_matrix(w.T @ w, file=file)


def demo_gauss(mats: np.ndarray, file=None) -> None:
    """Gauss-Jordan inverse with partial pivoting (the CPU oracle)."""
    file = file or sys.stdout
    from cuda_matrix_inversion_tpu.ops.cpu_reference import (
        inverse_gauss_jordan,
    )

    with np.errstate(divide="ignore", invalid="ignore"):
        inv = inverse_gauss_jordan(mats.astype(np.float32))
    for k, (a, i) in enumerate(zip(mats, inv)):
        print(f"matrix {k}: input", file=file)
        print_matrix(a, file=file)
        if not np.isfinite(i).all():
            # the defined singular-input behavior: elimination propagates
            # non-finite values (pivot 0 → inf/nan), detected here per
            # matrix — where the reference's pivot kernel had an empty
            # else-branch and silently produced garbage
            # (``batched_invert.cu:29-31``, SURVEY §2.4.3)
            print(f"matrix {k} is SINGULAR (no inverse; "
                  "non-finite pivot encountered)\n", file=file)
            continue
        print("A^-1 (Gauss-Jordan, partial pivoting):", file=file)
        print_matrix(i, file=file)
        err = np.abs(a @ i.astype(np.float64) - np.eye(a.shape[0])).max()
        print(f"max |AA^-1 - I| = {err:.3e}\n", file=file)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="cuda_matrix_inversion_tpu.demos",
        description="stdin teaching demos (reference inverse_cholesky_cpu / "
                    "gauss prototypes)")
    parser.add_argument("which", nargs="?", default="cholesky",
                        choices=["cholesky", "gauss"])
    parser.add_argument(
        "--backend", default="cpu", choices=["auto", "cpu"],
        help="cpu (default) pins the CPU backend; auto lets JAX choose")
    args = parser.parse_args(argv)
    mats = read_stdin_matrices()
    if args.which == "cholesky":
        demo_cholesky(mats)  # pure numpy — never touches a device
        return 0
    from cuda_matrix_inversion_tpu.utils.backend import pin_backend

    pin_backend(args.backend)
    demo_gauss(mats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
