#!/usr/bin/env python3
"""K1's bf16 default form per UNet forward in checkouts of the port
(`sin3dm_tpu_torch`), timed one after another on one CUDA card:

    python3 scripts/torch_k1_versions.py [CHECKOUT ...]

(default: this checkout).  Give an older checkout first and last, and
this one twice between, to compare two versions within one run.  Each
checkout runs in a process of its own, which builds and imports that
checkout's kernels.  The inputs are `chip_smoke.py`'s: the towerruins
UNet's triplane 3x3 convs at batch 2 (`k1_groups`, `group_inputs`), fp32
weights as the model holds them.  A checkout whose wrapper has
`conv3x3_rollout_triplane` gets one call per triplane conv (8 per
forward), with the weights packed once as its UNet passes them; an
older one one `conv3x3_rollout` call per plane (24 per forward), with
the weights as its UNet passed them.  Per checkout it prints one JSON
line, per forward: `ms` by CUDA events (`chip_smoke.time_ms`),
`device_ms` of the kernels whose name holds "conv3x3" and
`device_all_ms` of every device operation of those calls (both
`chip_smoke.device_ms`), `host_ms` (`chip_smoke.host_ms`).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(checkout: str) -> dict:
    """The per-forward numbers of one checkout (run in its own process)."""
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs        # this checkout's timing helpers
    sys.path.insert(0, checkout)   # and that checkout's port
    from sin3dm_tpu_torch.ops import fused_conv as fc

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    triplane = hasattr(fc, "conv3x3_rollout_triplane")
    g = torch.Generator(device="cuda").manual_seed(4)
    out = {"ms": 0.0, "device_ms": 0.0, "device_all_ms": 0.0,
           "host_ms": 0.0, "calls": 0}
    for planes, C, Co, n, _ in cs.k1_groups():
        ops = cs.group_inputs(g, 2, planes, C, Co)
        args = [(op["x"].bfloat16(), op["w"], op["b"],
                 op["col3"].bfloat16(), op["row3"].bfloat16())
                for op in ops]
        if triplane:
            packed = [fc.pack_conv_weights(op["w"]) for op in ops]
            cols = [list(a) for a in zip(*args)]

            def call():
                return fc.conv3x3_rollout_triplane(*cols, packed=packed)
        else:
            def call():
                return [fc.conv3x3_rollout(*a) for a in args]
        for k, v in (("ms", cs.time_ms(call)),
                     ("device_ms", cs.device_ms(call, "conv3x3")),
                     ("device_all_ms", cs.device_ms(call)),
                     ("host_ms", cs.host_ms(call))):
            out[k] += n * v
        out["calls"] += n * (1 if triplane else len(planes))
    return out


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        print(json.dumps(measure(argv[1])))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_k1_versions: needs a CUDA card", file=sys.stderr)
        return 1
    for checkout in argv or [ROOT]:
        checkout = os.path.abspath(checkout)
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", checkout], capture_output=True,
                             text=True, check=False)
        if res.returncode != 0:
            sys.stderr.write(res.stdout + res.stderr)
            return res.returncode
        line = json.loads(res.stdout.strip().splitlines()[-1])
        print(json.dumps({"checkout": checkout, **line}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
