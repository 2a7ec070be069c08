"""The full evaluation (counterpart of `sin3dm_tpu/evaluation/eval_full.py`):
SSFID, LP-IoU, LP-F-score and Div over the generated voxel grids,
multi-view SIFID (dims 64 and 192) and LPIPS over their renders, written
to one JSON with the JAX package's keys.

The geometry metrics need nothing else; SSFID, SIFID and LPIPS need the
published weight files, and each is skipped with a note where its file
is absent.  It runs on the card unless `--device cpu` is given; without a
card `--device cuda` raises.  The convs and matmuls run in true fp32
(TF32 off) throughout, and the flags are restored after.

Usage:
    python -m sin3dm_tpu_torch.evaluation.eval_full -s RESULT_DIR -r REF_DIR \
        [--device cuda|cpu] [--ssfid_weights Clsshapenet_128.pth]
        [--inception_weights inception_v3.pth]
        [--alexnet_weights alexnet.pth --lpips_weights lpips_weights.ckpt]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time
from typing import Optional

from ..cli.sample import resolve_device
from . import patch_metrics


def main(argv=None, seconds: Optional[dict] = None) -> dict:
    """Evaluate, write the JSON and return its dict; where `seconds` is
    given, it receives the seconds of each metric (lp, div, ssfid,
    sifid64, sifid192, lpips), each ending in a copy to the host."""
    parser = argparse.ArgumentParser()
    parser.add_argument("-s", "--src", type=str, required=True,
                        help="generated results dir (contains NNN/ subdirs)")
    parser.add_argument("-r", "--ref", type=str, required=True,
                        help="reference data dir (contains *.npz + "
                             "renderings/)")
    parser.add_argument("-o", "--output", type=str, default=None)
    # weight paths: flag, else environment variable, else the file's name
    env = os.environ.get
    parser.add_argument("--ssfid_weights", type=str,
                        default=env("SSFID_WEIGHTS", "Clsshapenet_128.pth"))
    parser.add_argument("--inception_weights", type=str,
                        default=env("INCEPTION_WEIGHTS", "inception_v3.pth"))
    parser.add_argument("--alexnet_weights", type=str,
                        default=env("ALEXNET_WEIGHTS", "alexnet.pth"))
    parser.add_argument("--lpips_weights", type=str,
                        default=env("LPIPS_WEIGHTS", "lpips_weights.ckpt"))
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    results = {}
    seconds = {} if seconds is None else seconds
    clock = [time.perf_counter()]

    def lap(metric: str) -> None:
        now = time.perf_counter()
        seconds[metric] = now - clock[0]
        clock[0] = now

    gen_vox_paths = sorted(glob.glob(os.path.join(args.src, "*",
                                                  "*voxel.npz")))
    ref_npz = sorted([p for p in glob.glob(os.path.join(args.ref, "*.npz"))
                      if "voxel" not in os.path.basename(p)])
    print(f"{len(gen_vox_paths)} generated voxel grids; ref npz: {ref_npz}")

    with patch_metrics.exact_fp32():
        if gen_vox_paths and ref_npz:
            ref_grid = patch_metrics.load_sdf_npz_as_voxel(ref_npz[0],
                                                           device=device)
            gen_grids = [patch_metrics.load_voxel_npz(p, device=device)
                         for p in gen_vox_paths]
            lp = patch_metrics.eval_lp_full(gen_grids, ref_grid)
            results.update(lp)
            # the avg variant under the names of earlier results
            results["LP_IOU"] = lp["LP-IOU-avg"]
            results["LP_F_score"] = lp["LP-F-score-avg"]
            lap("lp")
            results["Div"] = patch_metrics.eval_div(gen_grids)
            lap("div")
            del gen_grids, ref_grid

            if os.path.exists(args.ssfid_weights):
                from .ssfid import eval_ssfid
                results.update(eval_ssfid(gen_vox_paths, ref_npz[0],
                                          args.ssfid_weights,
                                          device=device))
                lap("ssfid")
            else:
                results["SSFID_note"] = (
                    f"skipped: weights '{args.ssfid_weights}' not found")

        gen_render_dirs = sorted(glob.glob(os.path.join(args.src, "*",
                                                        "renderings")))
        ref_render_dir = os.path.join(args.ref, "renderings")
        if gen_render_dirs and os.path.isdir(ref_render_dir):
            if os.path.exists(args.inception_weights):
                from .sifid import calculate_multiview_sifid
                for dims in (64, 192):
                    results.update(calculate_multiview_sifid(
                        gen_render_dirs, ref_render_dir,
                        args.inception_weights, dims=dims, device=device))
                    lap(f"sifid{dims}")
            else:
                results["sifid_note"] = (
                    f"skipped: weights '{args.inception_weights}' not found")
            if (os.path.exists(args.alexnet_weights)
                    and os.path.exists(args.lpips_weights)):
                from .lpips import calculate_multiview_lpips
                results.update(calculate_multiview_lpips(
                    gen_render_dirs, args.alexnet_weights,
                    args.lpips_weights, device=device))
                lap("lpips")
            else:
                results["lpips_note"] = ("skipped: alexnet/lpips weights "
                                         "not found")

    out_path = args.output or os.path.join(args.src, "eval_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results, indent=2))
    return results


if __name__ == "__main__":
    main()
