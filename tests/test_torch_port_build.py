"""The port's kernel builder on the CPU (no nvcc needed): a library's
name hashes its source, every shared header and the flags, so editing a
header builds anew instead of loading a stale library."""

import shutil

from sin3dm_tpu_torch.ops import _build


def _copy(tmp_path):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    return csrc


def test_target_names_every_source_and_header():
    headers = sorted(_build.CSRC.glob("*.cuh"))
    assert headers, "the kernels share at least one csrc/*.cuh header"
    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    assert {"fused_conv", "fused_mlp", "tnorm"} <= set(names)
    for name in names:
        t = _build.target(name)
        assert t.parent == _build.BUILD_DIR and t.name.startswith(name + "-")
        assert _build.target(name) == t          # stable across calls


def test_editing_a_header_changes_the_target(tmp_path):
    csrc = _copy(tmp_path)
    before = {n: _build.target(n, csrc) for n in ("fused_conv", "fused_mlp")}
    assert before == {n: _build.target(n) for n in before}
    hdr = sorted(csrc.glob("*.cuh"))[0]
    hdr.write_text(hdr.read_text() + "\n// edited\n")
    after = {n: _build.target(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)


def test_adding_a_header_or_editing_a_source_changes_the_target(tmp_path):
    csrc = _copy(tmp_path)
    t0 = _build.target("fused_mlp", csrc)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    t1 = _build.target("fused_mlp", csrc)
    assert t1 != t0
    src = csrc / "fused_mlp.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.target("fused_mlp", csrc) != t1


def test_flags_change_the_target(tmp_path, monkeypatch):
    csrc = _copy(tmp_path)
    t0 = _build.target("fused_conv", csrc)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.target("fused_conv", csrc) != t0
