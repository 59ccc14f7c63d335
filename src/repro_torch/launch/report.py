"""Assemble the dry run's tables from results/dryrun_torch/ (twin of the
reference's ``launch/report.py``).

Usage: ``python -m repro_torch.launch.report [--results DIR]``.
"""
import argparse
import json
from pathlib import Path

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def _fmt(x, nd=3):
    if x is None:
        return "-"
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) < 1e-3 or abs(x) >= 1e4:
            return f"{x:.2e}"
        return f"{x:.{nd}g}"
    return str(x)


def load_cells(results: Path = RESULTS):
    cells = []
    for f in sorted(Path(results).glob("*.json")):
        d = json.loads(f.read_text())
        d["_file"] = f.stem
        cells.append(d)
    return cells


def _collectives(d) -> str:
    colls = d.get("hlo", {}).get("collectives", {})
    return ",".join(f"{k.split('_')[-1][:4] if k.startswith('all_') else k[:4]}:{v}"
                    for k, v in sorted(colls.items())) or "-"


def dryrun_table(cells, multi_pod):
    lines = ["| arch | shape | status | trace_s | HBM/dev (GB) | collectives |",
             "|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("multi_pod") != multi_pod or "-mpc-" in d.get("arch", ""):
            continue
        tot = d.get("memory", {}).get("total_bytes")
        status = d["status"]
        if status == "skipped":
            status += " (" + d.get("reason", "")[:40] + ")"
        lines.append(
            f"| {d['arch']} | {d['shape']} | {status} "
            f"| {_fmt(d.get('trace_s'))} "
            f"| {_fmt(tot / 1e9 if tot else None)} | {_collectives(d)} |")
    return "\n".join(lines)


def roofline_table(cells):
    lines = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
             "| MODEL/HLO flops | roofline frac |",
             "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("multi_pod") or d.get("status") != "ok" \
                or "-mpc-" in d.get("arch", ""):
            continue
        r = d.get("roofline", {})
        lines.append(
            f"| {d['arch']} | {d['shape']} | {_fmt(r.get('compute_s'))} "
            f"| {_fmt(r.get('memory_s'))} | {_fmt(r.get('collective_s'))} "
            f"| {r.get('dominant', '-').replace('_s', '')} "
            f"| {_fmt(r.get('useful_flops_ratio'))} "
            f"| {_fmt(r.get('roofline_fraction'))} |")
    return "\n".join(lines)


def mpc_table(cells):
    lines = ["| config | collective B/dev | memory_s | collective_s | dominant |",
             "|---|---|---|---|---|"]
    for d in cells:
        if "-mpc-" not in d.get("arch", "") or "-mpc-lm-" in d.get("arch", "") \
                or d.get("status") != "ok":
            continue
        r = d.get("roofline", {})
        cb = d.get("hlo", {}).get("collective_bytes")
        lines.append(f"| {d['arch']} | {_fmt(cb)} | {_fmt(r.get('memory_s'))} "
                     f"| {_fmt(r.get('collective_s'))} "
                     f"| {r.get('dominant', '-').replace('_s', '')} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    cells = load_cells(Path(ap.parse_args(argv).results))
    print("## Single-pod (16x16)\n")
    print(dryrun_table(cells, False))
    print("\n## Multi-pod (2x16x16)\n")
    print(dryrun_table(cells, True))
    print("\n## Roofline (single-pod)\n")
    print(roofline_table(cells))
    print("\n## MPC serving\n")
    print(mpc_table(cells))


if __name__ == "__main__":
    main()
