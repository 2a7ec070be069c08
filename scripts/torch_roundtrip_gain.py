"""How far a DDIM-10 round trip carries an error of each UNet forward.

    python scripts/torch_roundtrip_gain.py [--device cuda|cpu] [--crop H W D]
        [--rel 1e-6 1e-5]
    python scripts/torch_roundtrip_gain.py --device cpu --crop 24 32 24

The port's DDIM inversion (`ddim_reverse_step`, 10 steps) of the
towerruins tag's feat.npz, then `ddim_sample_loop` back, in fp32 (TF32
off), once as it is and once with every forward's output multiplied by
(1 + rel * N(0, 1)).  Prints, per plane, how far x_T and the round trip's
x_0 moved, as a share of the plane's largest |value|, beside rel: the
gain that `chip_smoke.py` phase 11c's card-against-host tolerance of
the round trip is set from.  It runs on the card unless `--device cpu` is
given, and fails where there is none.  `--crop` cuts the planes (default:
the full 92 128 92); the second line above is a small run on the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--crop", type=int, nargs=3, default=(92, 128, 92))
    ap.add_argument("--rel", type=float, nargs="+", default=(1e-6, 1e-5))
    args = ap.parse_args(argv)
    os.environ["SIN3DM_SAMPLE_DTYPE"] = "train"
    import torch
    from sin3dm_tpu_torch.cli import sample as cli
    from sin3dm_tpu_torch.core.triplane import Triplane, load_triplane_npz
    from sin3dm_tpu_torch.diffusion import gaussian as tg
    from sin3dm_tpu_torch.diffusion import sampling as ts

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "checkpoints", "towerruins")
    dev = cli.resolve_device(args.device)
    sargs = cli.cfgmod.sample_args([
        "--tag", tag, "--use_ddim", "true", "--timestep_respacing", "ddim10",
        "--device", args.device])
    model, tables, dcfg = cli.build_model(sargs, dev)
    H, W, D = args.crop
    feat = load_triplane_npz(cli.cfgmod.encoding_feat_path(tag), dev)
    feat = Triplane(feat.xy[None, :H, :W], feat.xz[None, :H, :D],
                    feat.yz[None, :W, :D])

    def round_trip(rel):
        gen = torch.Generator(device=dev).manual_seed(0)

        def m(x, t):
            out = model(x, t)
            if not rel:
                return out
            return out.map(lambda p: p * (1 + rel * torch.randn(
                p.shape, generator=gen, device=dev)))
        with torch.no_grad():
            x = feat
            for t in range(tables["betas"].shape[0]):
                x = tg.ddim_reverse_step(m, tables, dcfg, x,
                                         torch.tensor([t], device=dev))
            x0 = ts.ddim_sample_loop(m, tables, dcfg, None, 1,
                                     feat.channels, feat.sizes, noise=x,
                                     device=dev)
        return x, x0

    base = round_trip(0.0)
    for rel in args.rel:
        moved = round_trip(rel)
        for name, a, b in (("x_T", base[0], moved[0]),
                           ("x_0", base[1], moved[1])):
            shares = [float((p - q).abs().max() / p.abs().max())
                      for p, q in zip(a, b)]
            print(f"rel {rel:g}: {name} moved by "
                  + ", ".join(f"{s:.3e}" for s in shares)
                  + f" of each plane's largest (gain up to "
                  f"{max(shares) / rel:.2f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
