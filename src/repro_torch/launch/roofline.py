"""Roofline over the one-card dry run's records (the port's counterpart
of ``repro.launch.roofline``), for the NVIDIA H100 80GB HBM3 (SXM) at
its 700 W limit (``kernels/work.py``'s data-sheet figures, dense).

Terms per (arch x shape), one card:
  compute_s    = FLOPs of each type / that type's peak (989e12 bf16,
                 67e12 fp32), summed
  memory_s     = HBM bytes / 3.35e12
  collective_s = 0 (the walk runs one rank; a mesh's collectives are
                 not walked, ROADMAP A13b-5b)
plus MODEL_FLOPS = 6·N·D train, 2·N·D prefill, 2·N·B decode (N the
active parameters at the walked depth, D the tokens, B the rows), the
useful ratio MODEL_FLOPS / walked FLOPs and the roofline fraction: the
useful FLOPs at the bf16 peak over the bound. Every figure is a bound
from the walk, not a measurement.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--tag baseline]
       PYTHONPATH=src python -m repro_torch.launch.roofline \
           --by-config baseline paged
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import List, Optional

from repro_torch.configs.registry import get_config
from repro_torch.configs.shapes import SHAPES_BY_NAME
from repro_torch.kernels.work import CARD, HBM_BYTES_PER_S, PEAK_FLOPS

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"


def model_flops(cfg, shape, batch: Optional[int] = None) -> float:
    """Analytic useful FLOPs of the whole step (paper-style 6·N·D) at
    ``batch`` rows (the shape's global batch if not given)."""
    n_act = cfg.active_param_count()
    rows = shape.global_batch if batch is None else batch
    tokens = rows * shape.seq_len
    if shape.kind == "train":
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        return 2.0 * n_act * tokens
    # decode: one token per sequence
    return 2.0 * n_act * rows


def analyze_record(rec: dict) -> dict:
    cfg = get_config(rec["arch"]).scaled(n_layers=rec["layers"])
    shape = SHAPES_BY_NAME[rec["shape"]]
    flops = rec["flops"]
    compute_s = sum(f / PEAK_FLOPS[d]
                    for d, f in rec["flops_by_dtype"].items())
    memory_s = rec["hbm_bytes"] / HBM_BYTES_PER_S
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": 0.0}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    mf = model_flops(cfg, shape, rec["batch"])
    useful_s = mf / PEAK_FLOPS["bfloat16"]
    return {**terms, "dominant": dominant[:-2], "bound_s": bound,
            "model_flops": mf, "useful_ratio": mf / max(flops, 1.0),
            "roofline_frac": useful_s / bound if bound > 0 else 0.0,
            "peak_gb": rec["memory"]["peak_bytes"] / 1e9,
            "fits": rec.get("fits"),
            "fit_depth": rec.get("fit", {}).get("depth")}


def build_table(tag: str, results_dir: Path) -> str:
    rows: List[str] = [
        f"Bounds from the dry run's walk, not measurements: {CARD} "
        f"(data sheet, dense).", "",
        "| arch | shape | layers | batch | peak GB | fits | deepest that "
        "fits | compute_s | memory_s | collective_s | bound | MODEL_FLOPS "
        "| useful | roofline |",
        "|" + "---|" * 14]
    for f in sorted(results_dir.glob(f"{tag}__*.json")):
        rec = json.loads(f.read_text())
        a = analyze_record(rec)
        fits = {True: "yes", False: "no", None: "—"}[a["fits"]]
        depth = "—" if a["fit_depth"] is None else \
            f"{a['fit_depth']} of {rec['full_layers']}"
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['layers']} "
            f"| {rec['batch']} | {a['peak_gb']:.2f} | {fits} | {depth} "
            f"| {a['compute_s']:.4f} | {a['memory_s']:.4f} "
            f"| {a['collective_s']:.4f} | **{a['dominant']}** "
            f"| {a['model_flops']:.3e} | {a['useful_ratio']:.3f} "
            f"| {a['roofline_frac']:.3f} |")
    return "\n".join(rows)


def build_config_table(tags: List[str], results_dir: Path) -> str:
    """One row per arch, one column per shape (and tag): each cell
    "peak GB (deepest depth that fits) dominant term, useful ratio,
    roofline fraction"."""
    cells, cols = {}, []
    for tag in tags:
        for f in sorted(results_dir.glob(f"{tag}__*.json")):
            rec = json.loads(f.read_text())
            a = analyze_record(rec)
            col = rec["shape"] + ("" if tag == tags[0] else f" ({tag})")
            if col not in cols:
                cols.append(col)
            depth = "" if a["fit_depth"] is None else \
                f" ({a['fit_depth']}/{rec['full_layers']})"
            cells.setdefault(rec["arch"], {})[col] = (
                f"{a['peak_gb']:.1f}{depth} {a['dominant'][:3]} "
                f"{a['useful_ratio']:.2f} {a['roofline_frac']:.2f}")
    order = [s for s in SHAPES_BY_NAME if s in cols]
    cols = order + [c for c in cols if c not in order]
    rows = ["| arch | " + " | ".join(cols) + " |",
            "|" + "---|" * (len(cols) + 1)]
    for arch in sorted(cells):
        rows.append(f"| {arch} | " + " | ".join(
            cells[arch].get(c, "—") for c in cols) + " |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--dir", default=str(RESULTS_DIR))
    ap.add_argument("--by-config", nargs="+", metavar="TAG",
                    help="one row per arch over these tags' records (the "
                         "first tag's shapes, then the others')")
    args = ap.parse_args(argv)
    if args.by_config:
        print(build_config_table(args.by_config, Path(args.dir)))
        return
    table = build_table(args.tag, Path(args.dir))
    out = Path(args.dir) / f"roofline_{args.tag}.md"
    out.write_text(table + "\n")
    print(table)
    print(f"\nwritten to {out}")


if __name__ == "__main__":
    main()
