"""The kernel library is built once per checkout: a later run reuses it
while the sources, the build module, the flags and ``nvcc`` are the same,
and builds it again when any of them changes."""

import types

from snapbench.systems import cache_kernel_build


def fake_build_module(tmp_path, built: list):
    """A stand-in for the program's build module, in a fresh process."""
    mod = types.ModuleType("fake_build")
    mod.__file__ = str(tmp_path / "_build.py")
    mod.CSRC = tmp_path / "csrc"
    mod.BUILD_DIR = tmp_path / "build"
    mod.LIB_NAME = "libfake.so"
    mod.NVCC_FLAGS = ["-O3"]

    def build():
        mod.BUILD_DIR.mkdir(exist_ok=True)
        out = mod.BUILD_DIR / mod.LIB_NAME
        out.write_bytes(b"lib")
        built.append(out)
        return out

    mod.build = build
    cache_kernel_build(mod)
    return mod


def test_a_second_run_reuses_the_library_until_an_input_changes(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "csrc" / "k.cu").write_text("kernel 1")
    (tmp_path / "_build.py").write_text("link command 1")
    built = []
    lib = fake_build_module(tmp_path, built).build()
    assert lib.is_file() and len(built) == 1
    fake_build_module(tmp_path, built).build()
    assert len(built) == 1
    (tmp_path / "_build.py").write_text("link command 2")
    fake_build_module(tmp_path, built).build()
    assert len(built) == 2
    (tmp_path / "csrc" / "k.cu").write_text("kernel 2")
    fake_build_module(tmp_path, built).build()
    assert len(built) == 3
    fake_build_module(tmp_path, built).build()
    assert len(built) == 3


def test_wrapping_twice_wraps_once(tmp_path):
    (tmp_path / "csrc").mkdir()
    (tmp_path / "_build.py").write_text("")
    built = []
    mod = fake_build_module(tmp_path, built)
    wrapped = mod.build
    cache_kernel_build(mod)
    assert mod.build is wrapped
