"""The kernel build (vault_tpu_torch/ops/_build.py) with a stand-in compiler.

There is no nvcc here, so a small script plays it: these tests check the
build's own logic — one compiler process per source, a library named after
the sources' hash, reuse of a library already built, and a failed build
that raises with the compiler's output instead of falling back.
"""

import os
import stat

import pytest

from vault_tpu_torch.ops import _build


def _fake_nvcc(tmp_path, body):
    script = tmp_path / "nvcc"
    script.write_text("#!/bin/sh\n" + body)
    script.chmod(script.stat().st_mode | stat.S_IEXEC)
    return str(script)


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_build_compiles_each_source_once_and_reuses_it(tmp_path, build_dir,
                                                       monkeypatch):
    calls = tmp_path / "calls"
    # write the file named after -o, log the source compiled
    nvcc = _fake_nvcc(tmp_path, f'''
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "$prev" >> {calls}
echo "ptxas info    : Used 42 registers"
: > "$out"
''')
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    built = _build.build_all()
    assert set(built) == set(_build.SOURCES)
    assert all("Used 42 registers" in log for _, log in built.values())
    compiled = calls.read_text().split()
    assert sorted(os.path.basename(c) for c in compiled) == sorted(
        f"{name}.cu" for name in _build.SOURCES)
    for name in _build.SOURCES:
        lib = _build._lib_path(name)
        assert lib.exists() and lib.parent == build_dir
        assert lib.name.startswith(f"lib{name}-") and lib.suffix == ".so"
    again = _build.build_all()
    assert again == {name: (0.0, "") for name in _build.SOURCES}
    assert len(calls.read_text().split()) == len(_build.SOURCES)


def test_failed_build_raises_with_the_compiler_output(tmp_path, build_dir,
                                                      monkeypatch):
    nvcc = _fake_nvcc(tmp_path, 'echo "error: no sm_90a here"; exit 3\n')
    monkeypatch.setattr(_build, "nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _build.build_all()
    assert not any(_build._lib_path(n).exists() for n in _build.SOURCES)


def test_launch_error_code_raises():
    class Lib:
        @staticmethod
        def vt_error_string(code):
            return b"too many resources requested for launch"

    _build.check(Lib, 0, "mlp")
    with pytest.raises(RuntimeError, match="too many resources"):
        _build.check(Lib, 7, "mlp")
