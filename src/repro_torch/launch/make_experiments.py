"""The dry run's data tables from results/dryrun_torch/ (twin of the
reference's ``launch/make_experiments.py``), MFU taken at the H100's
datasheet peak (``runtime/roofline.PEAK_FLOPS``).

Usage: ``python -m repro_torch.launch.make_experiments [--results DIR]``.
"""
import argparse
import json
from pathlib import Path

from ..runtime.roofline import PEAK_FLOPS

RESULTS = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
PEAK = PEAK_FLOPS


def _fmt(x, nd=3):
    if x is None:
        return "-"
    if isinstance(x, float):
        if x == 0:
            return "0"
        if abs(x) < 1e-3 or abs(x) >= 1e5:
            return f"{x:.2e}"
        return f"{x:.{nd}g}"
    return str(x)


def load(results: Path = RESULTS):
    out = []
    for f in sorted(Path(results).glob("*.json")):
        d = json.loads(f.read_text())
        d["_file"] = f.stem
        out.append(d)
    return out


def mfu(d):
    """Model-FLOP utilisation at the step's roofline bound, per card."""
    r = d.get("roofline", {})
    mf = r.get("model_flops_global")
    bound = r.get("step_time_bound_s")
    n = d.get("n_chips", 256)
    if not mf or not bound:
        return None
    return (mf / n / PEAK) / bound


def dryrun_table(cells, multi_pod):
    lines = ["| arch | shape | status | trace_s | HBM/dev GB | collective ops |",
             "|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("multi_pod") != multi_pod or "-mpc-" in d.get("arch", "") \
                or "_iter" in d["_file"]:
            continue
        tot = d.get("memory", {}).get("total_bytes")
        colls = d.get("hlo", {}).get("collectives", {})
        cs = ",".join(f"{k}:{v}" for k, v in sorted(colls.items())) or "-"
        status = d["status"]
        if status == "skipped":
            status += " (sub-quadratic rule)"
        elif status == "error":
            status += " (" + d.get("error", "")[:60] + ")"
        lines.append(f"| {d['arch']} | {d['shape']} | {status} "
                     f"| {_fmt(d.get('trace_s'))} "
                     f"| {_fmt(tot / 1e9 if tot else None)} | {cs} |")
    return "\n".join(lines)


def roofline_table(cells):
    lines = ["| arch | shape | compute_s | memory_s | collective_s | dominant "
             "| useful FLOPs | MFU@bound |",
             "|---|---|---|---|---|---|---|---|"]
    for d in cells:
        if d.get("multi_pod") or d.get("status") != "ok" \
                or "-mpc-" in d.get("arch", "") or "_iter" in d["_file"]:
            continue
        r = d.get("roofline", {})
        lines.append(
            f"| {d['arch']} | {d['shape']} | {_fmt(r.get('compute_s'))} "
            f"| {_fmt(r.get('memory_s'))} | {_fmt(r.get('collective_s'))} "
            f"| {r.get('dominant', '-').replace('_s', '')} "
            f"| {_fmt(r.get('useful_flops_ratio'))} | {_fmt(mfu(d), 4)} |")
    return "\n".join(lines)


def summary_table(cells):
    """One row per (arch, shape): per card, each mesh's peak GB, step bound
    (s, and its dominant term), MFU at the bound and trace seconds."""
    by = {}
    for d in cells:
        if "-mpc-" in d.get("arch", "") or "_iter" in d["_file"]:
            continue
        by.setdefault((d["arch"], d["shape"]), {})[bool(d.get("multi_pod"))] = d

    def one(d):
        if d is None:
            return "-"
        if d["status"] != "ok":
            return d["status"]
        r = d["roofline"]
        peak = d["memory"]["peak_bytes"] / 1e9
        term = {"compute_s": "comp", "memory_s": "mem", "collective_s": "coll"}
        return (f"{peak:.3g} GB, {_fmt(r['step_time_bound_s'])} s "
                f"{term[r['dominant']]}, MFU {_fmt(mfu(d), 2)}, {d['trace_s']:.0f} s")

    lines = ["| arch | shape | 16x16: peak, bound, MFU, trace | 2x16x16: same |",
             "|---|---|---|---|"]
    for (arch, shape), pair in sorted(by.items()):
        if all(d["status"] == "skipped" for d in pair.values()):
            continue
        lines.append(f"| {arch} | {shape} | {one(pair.get(False))} | {one(pair.get(True))} |")
    return "\n".join(lines)


def mpc_table(cells):
    lines = ["| config | rounds | collective MB/dev | vs baseline | pool MB/dev |",
             "|---|---|---|---|---|"]
    base = None
    for d in cells:
        if d.get("arch") == "resnet18-mpc-baseline" and d.get("status") == "ok":
            base = d.get("hlo", {}).get("collective_bytes")
    for tag in ("baseline", "eco", "8of64", "8of64cone"):
        for d in cells:
            if d.get("arch") == f"resnet18-mpc-{tag}" and d.get("status") == "ok":
                cb = d.get("hlo", {}).get("collective_bytes")
                red = f"{base / cb:.2f}x" if base and cb else "-"
                m = d.get("mpc", {})
                lines.append(f"| {tag} | {m.get('rounds', '-')} | {_fmt(cb / 1e6)} "
                             f"| {red} | {_fmt(m.get('pool_bytes_per_rank', 0) / 1e6)} |")
    return "\n".join(lines)


def lm_mpc_table(cells):
    lines = ["| arch | shape | budget | rounds | MB | LAN s | WAN s |",
             "|---|---|---|---|---|---|---|"]
    for d in cells:
        if "-mpc-lm-" not in d.get("arch", "") or d.get("status") != "ok":
            continue
        m = d.get("lm", {})
        budget = d["arch"].rsplit("-", 1)[-1]
        lines.append(
            f"| {d['arch'].split('-mpc-')[0]} | {d.get('shape', '-')} "
            f"| {budget} | {m.get('rounds', '-')} "
            f"| {_fmt((m.get('bytes_tx') or 0) / 1e6)} "
            f"| {_fmt(m.get('latency_lan_s'))} "
            f"| {_fmt(m.get('latency_wan_s'))} |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--results", default=str(RESULTS))
    cells = load(Path(ap.parse_args(argv).results))
    print("<!-- generated by repro_torch.launch.make_experiments -->")
    print("\n### Single-pod (16x16 = 256 ranks)\n")
    print(dryrun_table(cells, False))
    print("\n### Multi-pod (2x16x16 = 512 ranks)\n")
    print(dryrun_table(cells, True))
    print("\n### Per card, both meshes (H100 datasheet peaks)\n")
    print(summary_table(cells))
    print(f"\n### Roofline (single-pod; H100 datasheet peaks, MFU at {PEAK:.4g} FLOP/s)\n")
    print(roofline_table(cells))
    print("\n### MPC ResNet18 serving (party x data = 2 x 256, 512 CIFAR samples)\n")
    print(mpc_table(cells))
    print("\n### MPC private LM (reduced-ring plan prediction)\n")
    print(lm_mpc_table(cells))


if __name__ == "__main__":
    main()
