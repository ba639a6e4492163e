"""The roofline of a step on one H100: three terms per device from a dry-run record.

Counterpart of ``benchmarks/roofline.py``, whose constants are a TPU's; these
are the card's, from ``repro_torch/hardware.py`` (NVIDIA H100 SXM data sheet,
dense rates, at the full 700 W power limit):

    compute    = bf16 FLOPs / 989 TFLOP/s + float32 FLOPs / 67 TFLOP/s
    memory     = bytes accessed / 3.35 TB/s (HBM3)
    collective = wire bytes / 450 GB/s (NVLink, one direction)

All inputs are per device, from the records ``repro_torch.launch.dryrun``
writes (its ``dispatch_analysis``: what the port's eager step dispatches, op
by op, on fake tensors).  MODEL_FLOPS is 6 N_active D for training and 2
N_active D for prefill and decode; the dispatched / MODEL ratio shows
recomputation and padding.  The roofline fraction is compute / max(terms).

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.hardware import HBM_BW, LINK_BW, PEAK_FLOPS

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS", "analyze_record", "bound_ms", "load_all", "run"]

LEVERS = {
    "compute": "cut recomputation (dispatched / MODEL ratio), float32 products out of the step, skip masked "
               "attention tiles",
    "memory": "fewer round trips through HBM: fuse elementwise passes into the kernels, bf16 intermediates",
    "collective": "bigger blocks a collective, overlap with compute, fewer resharding collectives",
}


def _terms(d: Dict) -> Dict[str, float]:
    compute = d["bf16_flops_per_device"] / PEAK_FLOPS["bfloat16"] + d["f32_flops_per_device"] / PEAK_FLOPS["float32"]
    return {"compute": compute, "memory": d["bytes_accessed_per_device"] / HBM_BW,
            "collective": d["wire_bytes_per_device"] / LINK_BW}


def bound_ms(rec: Dict) -> float:
    """The least time of the record's step on one card: the largest of its three terms, in ms."""
    return max(_terms(rec["dispatch_analysis"]).values()) * 1e3


def analyze_record(rec: Dict) -> Optional[Dict]:
    """The three terms (seconds), the dominant one, the roofline fraction,
    MODEL_FLOPS against the FLOPs dispatched over all devices, and the temp
    GiB; None for a record that is not ``ok``."""
    if rec.get("status") != "ok":
        return None
    d = rec["dispatch_analysis"]
    m = rec["model"]
    terms = _terms(d)
    dominant = max(terms, key=terms.get)
    tokens = m["global_batch"] * (m["seq_len"] if m["kind"] != "decode" else 1)
    model_flops = (6 if m["kind"] == "train" else 2) * m["n_active_params"] * tokens
    dispatched = d["flops_per_device"] * rec["chips"]
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": rec["mesh"],
        "tag": rec.get("sync_strategy", "scu"),
        "compute_s": terms["compute"],
        "memory_s": terms["memory"],
        "collective_s": terms["collective"],
        "bound_s": terms[dominant],
        "dominant": dominant,
        "roofline_fraction": terms["compute"] / max(max(terms.values()), 1e-30),
        "model_flops": model_flops,
        "dispatched_flops_global": dispatched,
        "useful_ratio": model_flops / max(dispatched, 1e-30),
        "temp_gib": rec["memory"]["temp_bytes"] / 2**30,
        "peak_gib": rec["memory"]["peak_bytes"] / 2**30,
        "lever": LEVERS[dominant],
    }


def load_all(art_dir: str = "artifacts/dryrun_torch", mesh: str = "single") -> List[Dict]:
    rows = []
    d = Path(art_dir) / mesh
    if not d.exists():
        return rows
    for f in sorted(d.glob("*.json")):
        rec = json.loads(f.read_text())
        r = analyze_record(rec)
        if r is not None:
            r["file"] = f.name
            rows.append(r)
        elif rec.get("applicable") is False:
            rows.append({"arch": rec["arch"], "shape": rec["shape"], "mesh": mesh, "skip": rec.get("skip_reason", "")})
    return rows


def run(art_dir: str = "artifacts/dryrun_torch", verbose: bool = True) -> Dict:
    out = {}
    for mesh in sorted(p.name for p in Path(art_dir).iterdir() if p.is_dir()) if Path(art_dir).exists() else []:
        rows = load_all(art_dir, mesh)
        out[mesh] = rows
        if not verbose or not rows:
            continue
        print(f"\n== Roofline on one H100 ({mesh} mesh) ==")
        print(f"{'arch':22s} {'shape':12s} {'comp ms':>10s} {'mem ms':>10s} {'coll ms':>10s} {'dom':>5s} "
              f"{'RLfrac':>7s} {'useful':>7s} {'peak GiB':>9s}")
        for r in rows:
            if "skip" in r:
                print(f"{r['arch']:22s} {r['shape']:12s} SKIP ({r['skip'][:48]}...)")
                continue
            print(f"{r['arch']:22s} {r['shape']:12s} {r['compute_s'] * 1e3:10.2f} {r['memory_s'] * 1e3:10.2f} "
                  f"{r['collective_s'] * 1e3:10.2f} {r['dominant'][:4]:>5s} {r['roofline_fraction']:7.3f} "
                  f"{r['useful_ratio']:7.2f} {r['peak_gib']:9.2f}")
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    run(ap.parse_args(argv).dir)


if __name__ == "__main__":
    main()
