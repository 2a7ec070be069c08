"""The serving path (`cli/app.py`) on the CPU against the JAX package's
app: `list_checkpoints` equal to JAX's; the stdlib server driven as
`tests/test_e2e.py` drives JAX's (the form page, a JSON and a form-encoded
`/generate`, a GLB download with glTF magic) on the committed towerruins
weights at a small size (`--resize 0.125`, reso 32, texreso 64, 200
faces, fp32 UNet); the app's feat.npz equal, bit for bit, to
`cli.sample`'s for the same arguments; a tag that is not listed answered
with a 400 and nothing written; names escaped in the page; `main` under
a stubbed gradio as JAX's is tested; no card, no default generate; and
the kernels' launch counters exact under two threads."""

import json
import os
import sys
import threading
import types
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
import torch

from sin3dm_tpu.cli import app as japp
from sin3dm_tpu_torch.cli import app
from sin3dm_tpu_torch.cli import sample as sample_cli

torch.set_num_threads(2)
ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TAG = os.path.join(ROOT, "checkpoints", "towerruins")
SMALL = {"n_samples": 1, "reso": 32, "n_faces": 200, "texreso": 64,
         "resize_x": 0.125, "resize_y": 0.125, "resize_z": 0.125,
         "use_ddim": "true"}


def _tag_dir(root):
    """A tag under `root` that reads the committed weights; what the app
    writes goes under it, not under the repo's checkpoints."""
    tag = root / "towerruins"
    tag.mkdir(parents=True)
    for sub in ("encoding", "diffusion"):
        os.symlink(os.path.join(TAG, sub), tag / sub)
    return str(tag)


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    root = tmp_path_factory.mktemp("ckpts")
    tag = _tag_dir(root)
    (root / "a<b>&c" / "diffusion").mkdir(parents=True)
    srv = app.build_http_server(str(root), device="cpu")
    thr = threading.Thread(target=srv.serve_forever, daemon=True)
    thr.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", root, tag
    finally:
        srv.shutdown()
        thr.join(timeout=10)
        mp.undo()


def _post(base, body: dict, as_json: bool):
    if as_json:
        data = json.dumps(body).encode()
        ctype = "application/json"
    else:
        data = urllib.parse.urlencode(body).encode()
        ctype = "application/x-www-form-urlencoded"
    req = urllib.request.Request(base + "/generate", data=data,
                                 headers={"Content-Type": ctype})
    return urllib.request.urlopen(req, timeout=600).read()


def test_list_checkpoints_equals_jax(tmp_path):
    for name in ("b", "a", "c"):
        (tmp_path / name / "diffusion").mkdir(parents=True)
    (tmp_path / "not_a_tag").mkdir()
    (tmp_path / "file").write_text("")
    assert app.list_checkpoints(str(tmp_path)) == \
        japp.list_checkpoints(str(tmp_path)) == \
        [str(tmp_path / n) for n in ("a", "b", "c")]


def test_page_lists_and_escapes_the_names(server):
    base, root, tag = server
    page = urllib.request.urlopen(base + "/", timeout=30).read().decode()
    assert "<form" in page and f'value="{tag}"' in page
    assert "a&lt;b&gt;&amp;c" in page and "a<b>&c" not in page
    assert "TPU" not in page


@pytest.mark.parametrize("as_json", [True, False], ids=["json", "form"])
def test_generate_serves_glbs_equal_to_cli_sample(server, as_json,
                                                  tmp_path, monkeypatch):
    base, root, tag = server
    seed = 11 if as_json else 12
    body = dict(SMALL, tag=tag, seed=seed)
    if not as_json:
        body["use_ddim"] = "on"
    out = _post(base, body, as_json)
    if as_json:
        urls = json.loads(out)["glbs"]
    else:
        assert b'href="/glb/0"' in out
        urls = ["/glb/0"]
    assert urls == ["/glb/0"]
    glb = urllib.request.urlopen(base + urls[0], timeout=30).read()
    assert glb[:4] == b"glTF"
    assert int.from_bytes(glb[4:8], "little") == 2
    assert int.from_bytes(glb[8:12], "little") == len(glb)

    # the feat.npz equals cli.sample's for the same arguments
    monkeypatch.setenv("SIN3DM_SAMPLE_DTYPE", "train")
    sample_cli.main(["--tag", tag, "--device", "cpu", "--vox",
                     "--output", str(tmp_path / "cli"), "--seed", str(seed),
                     "--use_ddim", "true", "--timestep_respacing", "ddim100",
                     "--resize", "0.125", "0.125", "0.125", "--reso", "32"])
    with np.load(os.path.join(tag, "app_results", "000", "feat.npz")) as a, \
            np.load(tmp_path / "cli" / "000" / "feat.npz") as b:
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("bad", ["../x", "/tmp", "", "towerruins",
                                 "{root}/../outside"])
def test_unlisted_tag_is_refused_and_nothing_is_written(server, bad,
                                                        tmp_path):
    base, root, tag = server
    bad = bad.format(root=root)
    before = _tree(root), _tree(tmp_path)
    for as_json in (True, False):
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(base, dict(SMALL, tag=bad, seed=0), as_json)
        assert e.value.code == 400
    assert (_tree(root), _tree(tmp_path)) == before
    assert not os.path.exists(os.path.join(root, "..", "outside"))


def test_generate_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    tag = _tag_dir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.generate(tag, 1, 0, 32, 200, 64, 0.125, 0.125, 0.125, True)
    assert not os.path.exists(os.path.join(tag, "app_results"))


def test_main_with_stubbed_gradio(tmp_path, monkeypatch):
    """`main`'s gradio branch: 10 inputs, 4 outputs, results padded to 4
    (as tests/test_e2e.py holds JAX's), `--device` passed through."""
    calls = {}

    class _Comp:
        def __init__(self, *a, **k):
            self.kwargs = k

        def __enter__(self):
            return self

        def __exit__(self, *a):
            return False

    class _Button(_Comp):
        def click(self, fn, inputs, outputs):
            calls.update(fn=fn, n_inputs=len(inputs), n_outputs=len(outputs))

    class _Blocks(_Comp):
        def launch(self, share=False):
            calls["launched"] = share

    gr = types.ModuleType("gradio")
    for name in ("Markdown", "Row", "Dropdown", "Slider", "Checkbox",
                 "Model3D"):
        setattr(gr, name, _Comp)
    gr.Button, gr.Blocks = _Button, _Blocks
    monkeypatch.setitem(sys.modules, "gradio", gr)

    ckroot = tmp_path / "checkpoints"
    (ckroot / "expA" / "diffusion").mkdir(parents=True)
    (ckroot / "not_a_ckpt").mkdir()
    app.main(["--checkpoints", str(ckroot), "--device", "cpu"])
    assert calls["launched"] is False
    assert calls["n_inputs"] == 10 and calls["n_outputs"] == 4

    seen = {}

    def fake_generate(tag, n, seed, reso, n_faces, texreso, rx, ry, rz,
                      ddim, device):
        seen.update(tag=tag, n=n, seed=seed, reso=reso, ddim=ddim,
                    device=device)
        return ["a/object.glb", "b/object.glb"]

    monkeypatch.setattr(app, "generate", fake_generate)
    out = calls["fn"](str(ckroot / "expA"), 2.0, 7.0, 128, 5000, 1024,
                      1.0, 1.0, 1.0, True)
    assert out == ["a/object.glb", "b/object.glb", None, None]
    assert seen == {"tag": str(ckroot / "expA"), "n": 2, "seed": 7,
                    "reso": 128, "ddim": True, "device": "cpu"}


@pytest.mark.parametrize("counter", ["k1", "k2"])
def test_launch_counters_count_every_launch_from_two_threads(counter,
                                                             monkeypatch):
    """Concurrent requests launch from several threads; each launch must
    count once (forms and shapes too)."""
    from sin3dm_tpu_torch.ops import fused_conv, fused_mlp
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        if counter == "k1":
            fn = fused_conv.conv3x3_rollout
            monkeypatch.setattr(fn, "launches", 0)
            monkeypatch.setattr(fn, "form_launches", {})

            def count():
                fused_conv._count(None, None, False)
        else:
            fn = fused_mlp.skip_mlp
            monkeypatch.setattr(fn, "launches", 0)
            monkeypatch.setattr(fn, "shape_launches", {})

            def count():
                fused_mlp._count((8, 64, 1))
        n = 50_000
        threads = [threading.Thread(target=lambda: [count() for _ in
                                                    range(n)])
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    by = fn.form_launches if counter == "k1" else fn.shape_launches
    assert fn.launches == 2 * n and list(by.values()) == [2 * n]
