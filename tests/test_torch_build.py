"""The port's CUDA build and the limits its wrappers copy from the sources,
checked on the CPU (no nvcc is needed).

* `build.library_path` hashes a source together with every shared header
  of its directory, so an edited header gives a new library path and an
  unrelated file does not.
* The constants the Python wrappers mirror from ``csrc/`` equal the values
  in the source text, so the two cannot drift apart.
"""

import os
import re
import shutil

import pytest

from dbcsr_tpu_torch.acc import build, crosspack_kernel

CSRC = build.CSRC_DIR


def _copy_csrc(tmp_path):
    d = tmp_path / "csrc"
    shutil.copytree(CSRC, d)
    return str(d)


def _constexpr(source: str, name: str) -> int:
    """The value of ``constexpr <type> name = <int expr>;`` in a source."""
    with open(os.path.join(CSRC, source)) as f:
        text = f.read()
    m = re.search(rf"constexpr\s+\w+\s+{name}\s*=\s*([0-9 *]+);", text)
    assert m, f"{name} not found in {source}"
    return eval(m.group(1), {"__builtins__": {}})


@pytest.mark.parametrize("source", build.SOURCES)
def test_library_path_covers_shared_headers(source, tmp_path):
    d = _copy_csrc(tmp_path)
    before = build.library_path(source, d)
    assert before == build.library_path(source, d)
    header = os.path.join(d, "smm_warp.cuh")
    with open(header, "a") as f:
        f.write("\n// edited\n")
    edited = build.library_path(source, d)
    assert edited != before
    with open(os.path.join(d, "notes.txt"), "w") as f:
        f.write("not a source\n")
    assert build.library_path(source, d) == edited
    with open(os.path.join(d, "smm_extra.cuh"), "w") as f:
        f.write("#pragma once\n")
    assert build.library_path(source, d) != edited


@pytest.mark.parametrize("source", build.SOURCES)
def test_library_path_changes_with_the_source(source, tmp_path):
    d = _copy_csrc(tmp_path)
    before = build.library_path(source, d)
    with open(os.path.join(d, source), "a") as f:
        f.write("\n// edited\n")
    assert build.library_path(source, d) != before
    assert os.path.basename(before).startswith(f"lib{os.path.splitext(source)[0]}.")


@pytest.mark.parametrize("source", build.SOURCES)
def test_sources_include_only_headers_of_csrc(source):
    with open(os.path.join(CSRC, source)) as f:
        local = re.findall(r'#include\s+"([^"]+)"', f.read())
    assert local == ["smm_warp.cuh"]
    for name in local:
        assert os.path.isfile(os.path.join(CSRC, name)) and name.endswith(".cuh")


@pytest.mark.parametrize("name, expected", [
    ("MAX_P", lambda: crosspack_kernel.MAX_P),
    ("MAX_PACK_OUTPUTS", lambda: crosspack_kernel.MAX_PACK_OUTPUTS),
])
def test_wrapper_limits_mirror_the_source(name, expected):
    if name == "MAX_PACK_OUTPUTS":
        value = (_constexpr("smm_crosspack.cu", "MAXJ")
                 * _constexpr("smm_crosspack.cu", "MAX_THREADS"))
    else:
        value = _constexpr("smm_crosspack.cu", name)
    assert expected() == value
