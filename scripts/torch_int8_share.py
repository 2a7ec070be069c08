#!/usr/bin/env python3
"""The mesh path's int8 geo grid decoded on the card (K2, bf16) against
the plain versions on the host CPU (bf16 operands), over many samples of
the towerruins model:

    python3 scripts/torch_int8_share.py [--n_samples 16] [--seed 0]
        [--reso 64]

Draws `--n_samples` triplanes with the tag's default chain (DDPM-1000,
one batch), then compares each, and the tag's own feat.npz, at `--reso`
through `chip_smoke.int8_vs_plain`.  Per triplane it prints one JSON
line: the share of int8 voxels a bucket apart, the largest difference in
buckets, the sign flips, the fp32 grids' max error against the derived
per-voxel bound (`chip_smoke.geo_grid_bound`: the worst voxel's ratio,
and the max error over the largest bound), and whether each int8 grid is
exactly the floor quantization of its own fp32 grid; then a summary
line.
`chip_smoke.INT8_SHARE_BOUND` is set from the readings of seed 0.  Needs
one CUDA card; exits non-zero without one, or where a reading breaks the
exact quantization, the one-bucket limit, the sign-flip bound (1e-4 of
the voxels), `INT8_SHARE_BOUND` or the per-voxel geo-grid bound.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_samples", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reso", type=int, default=64)
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import load_triplane_npz
    if not torch.cuda.is_available():
        print("torch_int8_share: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"nvidia-smi: {cs.nvidia_smi_line()}", flush=True)
    out_dir = tempfile.mkdtemp(prefix="sin3dm_int8_share_")
    rows = []
    try:
        args = cli.cfgmod.sample_args([
            "--tag", cs.TAG, "--n_samples", str(a.n_samples), "--seed",
            str(a.seed), "--output", out_dir])
        feats = [("encoding/feat.npz", cli.cfgmod.encoding_feat_path(cs.TAG))]
        feats += [(os.path.relpath(p, out_dir), p)
                  for p in cli.sample_diffusion(args)]
        card = cli._make_trainer(args, torch.device("cuda"))
        host = cli._make_trainer(args, torch.device("cpu"))
        quant = float(card.meta["threshold"])
        for name, path in feats:
            r = cs.int8_vs_plain(card, host, load_triplane_npz(path), a.reso,
                                 quant)
            del r["grids"]
            rows.append({"feat": name, **r})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    shares = sorted(r["share"] for r in rows)
    ok = all(all(r["exact"]) and r["max_bucket"] <= 1
             and r["flips"] <= 1e-4 * r["voxels"]
             and r["share"] <= cs.INT8_SHARE_BOUND
             and r["ratio_voxel"] <= 1.0 for r in rows)
    print(json.dumps({"readings": len(rows), "seed": a.seed,
                      "reso": a.reso, "share_min": shares[0],
                      "share_median": shares[len(shares) // 2],
                      "share_max": shares[-1],
                      "share_bound": cs.INT8_SHARE_BOUND,
                      "flips_max": max(r["flips"] for r in rows),
                      "fp32_over_bound": sum(r["ratio_voxel"] > 1
                                             for r in rows),
                      "ratio_voxel_max": max(r["ratio_voxel"] for r in rows),
                      "ratio_max_max": max(r["ratio_max"] for r in rows),
                      "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
