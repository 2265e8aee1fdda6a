"""Render the port's dry-run results as the markdown table of ``PERF.md``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes \
        --workers 7 --out build/dryrun_all.json
    python scripts/torch_dryrun_table.py build/dryrun_all.json

One row a (cell, mesh), in the results' order: status (and trace seconds,
or the error of a ``FAIL``; a cell stopped at ``--timeout`` says so), GiB
a rank (the peak of live bytes), the dominant term, the three roofline
terms (H100 datasheet figures, ``launch.opanalysis.HW``) and
``roofline_fraction``.
"""
from __future__ import annotations

import argparse
import json
import sys


def row(c: dict) -> str:
    head = f"| {c['arch']} | {c['shape']} | {c['mesh']} |"
    if c["status"] != "OK":
        return f"{head} FAIL: {c['error'][:120]} | | | | | | |"
    r = c["roofline"]
    return (f"{head} OK ({c['trace_s']} s) | "
            f"{c['bytes_per_device'] / 2**30:.2f} | {r['dominant']} | "
            f"{r['compute_s']:.3g} | {r['memory_s']:.3g} | "
            f"{r['collective_s']:.3g} | {c['roofline_fraction']:.3g} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("results", help="the dry run's --out file")
    args = ap.parse_args(argv)
    with open(args.results) as f:
        cells = json.load(f)
    print("| arch | shape | mesh | status (trace s) | GiB a rank | dominant "
          "| compute s | memory s | collective s | roofline_fraction |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for c in cells:
        print(row(c))
    return 0


if __name__ == "__main__":
    sys.exit(main())
