"""Web demo over trained checkpoints (counterpart of
`sin3dm_tpu/cli/app.py`):

    python -m sin3dm_tpu_torch.cli.app [--checkpoints DIR] [--http]
        [--port 7860] [--device cuda|cpu]

Pick a checkpoint directory, draw N samples (DDPM-1000 or DDIM-100),
decode each to a textured GLB, and show or serve them.  The UI is
gradio's where it is installed; otherwise, or with `--http`, a stdlib
`http.server` serves the same controls as an HTML form and the GLBs for
download.  Generation runs on the card unless `--device cpu` is given.

The server takes only a tag that `list_checkpoints` lists under its
checkpoints root: any other (a path outside it, `../x`) gets a 400 and
nothing is written.  Checkpoint names are HTML-escaped in the page.
"""

from __future__ import annotations

import argparse
import glob
import html
import json
import os
import types


def list_checkpoints(root: str = "checkpoints"):
    """The directories under `root` that hold a `diffusion/` log."""
    return sorted([d for d in glob.glob(os.path.join(root, "*"))
                   if os.path.isdir(os.path.join(d, "diffusion"))])


def generate(tag: str, n_samples: int, seed: int, reso: int, n_faces: int,
             texreso: int, resize_x: float, resize_y: float,
             resize_z: float, use_ddim: bool, *, device: str = "cuda"):
    """Sample and decode to GLBs under `<tag>/app_results/<j:03d>/`;
    returns the `object.glb` paths.  `device` is `cuda` (where there is
    no card it raises before anything is written) or `cpu`."""
    from ..core import config as cfgmod
    from ..core.rng import seed_all
    from .sample import generate as sample_generate
    from .sample import resolve_device

    resolve_device(device)
    seed_all(seed)
    args = types.SimpleNamespace(
        tag=tag, n_samples=n_samples, output="app_results",
        resize=(resize_x, resize_y, resize_z), use_ddim=use_ddim,
        timestep_respacing="ddim100" if use_ddim else "",
        reso=reso, n_faces=n_faces, texreso=texreso, vox=False,
        copy_mtl=False, file_format="glb", seed=seed, app="generate",
        data_path=None, pipeline_chunk=1)
    cfgmod.load_and_overwrite_args(
        args, os.path.join(cfgmod.encoding_log_dir(tag), "args.json"))
    cfgmod.load_and_overwrite_args(
        args, os.path.join(cfgmod.diffusion_log_dir(tag), "args.json"),
        ignore_keys=["timestep_respacing"])
    args.device, args.gpu_id = device, 0
    paths, _ = sample_generate(args)
    return [os.path.join(os.path.dirname(p), "object.glb") for p in paths]


_PAGE = """<!doctype html><html><head><title>Sin3DM</title>
<style>body{{font-family:sans-serif;max-width:42em;margin:2em auto}}
label{{display:block;margin:.4em 0}}input,select{{margin-left:.5em}}
.glb a{{display:block;margin:.3em 0}}</style></head><body>
<h1>Sin3DM — single-shape 3D diffusion</h1>
<p>Results appear as downloadable GLB links below.</p>
<form method="post" action="/generate">
<label>checkpoint <select name="tag">{options}</select></label>
<label>samples <input type="number" name="n_samples" value="4" min="1"
 max="4"></label>
<label>seed <input type="number" name="seed" value="0"></label>
<label>DDIM-100 <input type="checkbox" name="use_ddim"></label>
<label>marching cubes resolution <input type="number" name="reso"
 value="256" min="32" max="512"></label>
<label>faces <input type="number" name="n_faces" value="10000"></label>
<label>texture resolution <input type="number" name="texreso"
 value="2048"></label>
<label>resize x/y/z <input name="resize_x" value="1.0" size="4">
<input name="resize_y" value="1.0" size="4">
<input name="resize_z" value="1.0" size="4"></label>
<button type="submit">Generate</button></form>
<div class="glb">{results}</div></body></html>"""


def _request_args(q, checkpoints_root: str):
    """generate's ten arguments from a parsed form or JSON body; raises
    ValueError for a tag that is not listed or a malformed number."""
    def g(k, d):
        return q.get(k, [d])[0]
    tag = str(g("tag", ""))
    if tag not in list_checkpoints(checkpoints_root):
        raise ValueError(f"unknown checkpoint {tag!r}")
    return (tag, int(g("n_samples", 1)), int(g("seed", 0)),
            int(g("reso", 256)), int(g("n_faces", 10000)),
            int(g("texreso", 2048)), float(g("resize_x", 1.0)),
            float(g("resize_y", 1.0)), float(g("resize_z", 1.0)),
            str(g("use_ddim", "")).lower() in ("on", "true", "1"))


def build_http_server(checkpoints_root: str = "checkpoints",
                      host: str = "127.0.0.1", port: int = 0,
                      device: str = "cuda"):
    """The stdlib demo server (a ThreadingHTTPServer: one thread per
    request; call .serve_forever()).

    Routes: GET / (the form), POST /generate (form or JSON body; runs
    :func:`generate` on `device`; JSON requests get {"glbs": [URL, ...]}
    back; a tag not listed under `checkpoints_root`, or a malformed
    number, gets a 400), GET /glb/<i> (the i-th GLB of the last
    generation)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *a):  # quiet logs
            pass

        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _page(self, results=""):
            opts = "".join(
                f'<option value="{html.escape(c)}">{html.escape(c)}'
                "</option>" for c in list_checkpoints(checkpoints_root))
            self._send(_PAGE.format(options=opts, results=results).encode(),
                       "text/html; charset=utf-8")

        def do_GET(self):
            if self.path.startswith("/glb/"):
                try:
                    idx = int(self.path.split("/")[2])
                    with open(self.server.last_glbs[idx], "rb") as f:
                        data = f.read()
                except (IndexError, ValueError, OSError):
                    self.send_error(404)
                    return
                self._send(data, "model/gltf-binary")
                return
            self._page()

        def do_POST(self):
            if self.path != "/generate":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(n).decode()
            is_json = "json" in self.headers.get("Content-Type", "")
            try:
                if is_json:
                    q = {k: [v] for k, v in json.loads(raw or "{}").items()}
                else:
                    q = parse_qs(raw)
                request = _request_args(q, checkpoints_root)
            except (ValueError, AttributeError) as e:
                self.send_error(400, str(e)[:200])
                return
            try:
                paths = generate(*request, device=device)
            except Exception as e:  # surface errors to the client
                self.send_error(500, str(e)[:200])
                return
            self.server.last_glbs = [p for p in paths if os.path.exists(p)]
            urls = [f"/glb/{i}" for i in range(len(self.server.last_glbs))]
            if is_json:
                self._send(json.dumps({"glbs": urls}).encode(),
                           "application/json")
            else:
                links = "".join(
                    f'<a href="{u}">sample {i} (GLB)</a>'
                    for i, u in enumerate(urls)) or "no samples decoded"
                self._page(results=links)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.last_glbs = []
    return srv


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoints", type=str, default="checkpoints")
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--http", action="store_true",
                        help="serve the stdlib HTTP UI even if gradio "
                             "is installed")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="generate on the card (default) or, when "
                             "asked, on the CPU")
    args = parser.parse_args(argv)

    try:
        if args.http:
            raise ImportError
        import gradio as gr
    except ImportError:
        srv = build_http_server(args.checkpoints, host="0.0.0.0",
                                port=args.port, device=args.device)
        if not args.http:
            print("gradio is not installed: serving the stdlib HTTP UI "
                  "instead")
        print(f"serving on http://{srv.server_address[0]}:"
              f"{srv.server_address[1]}")
        srv.serve_forever()
        return

    ckpts = list_checkpoints(args.checkpoints)

    with gr.Blocks(title="Sin3DM") as demo:
        gr.Markdown("# Sin3DM — single-shape 3D diffusion")
        with gr.Row():
            tag = gr.Dropdown(choices=ckpts, label="checkpoint",
                              value=ckpts[0] if ckpts else None)
        with gr.Row():
            n_samples = gr.Slider(1, 4, value=4, step=1, label="samples")
            seed = gr.Slider(0, 10000, value=0, step=1, label="seed")
            use_ddim = gr.Checkbox(value=False, label="DDIM-100")
        with gr.Row():
            reso = gr.Slider(64, 512, value=256, step=64,
                             label="marching cubes resolution")
            n_faces = gr.Slider(2000, 100000, value=10000, step=1000,
                                label="faces")
            texreso = gr.Slider(512, 4096, value=2048, step=512,
                                label="texture resolution")
        with gr.Row():
            rx = gr.Slider(0.5, 2.0, value=1.0, step=0.1, label="resize x")
            ry = gr.Slider(0.5, 2.0, value=1.0, step=0.1, label="resize y")
            rz = gr.Slider(0.5, 2.0, value=1.0, step=0.1, label="resize z")
        run_btn = gr.Button("Generate")
        outputs = [gr.Model3D(label=f"sample {i}") for i in range(4)]

        def _run(tag, n, seed, reso, n_faces, texreso, rx, ry, rz, ddim):
            paths = generate(tag, int(n), int(seed), int(reso),
                             int(n_faces), int(texreso), rx, ry, rz, ddim,
                             device=args.device)
            paths = paths + [None] * (4 - len(paths))
            return paths[:4]

        run_btn.click(_run, [tag, n_samples, seed, reso, n_faces, texreso,
                             rx, ry, rz, use_ddim], outputs)

    demo.launch(share=args.share)


if __name__ == "__main__":
    main()
