"""The kernels' build key (pytorch_camvid_tpu_torch/ops/cuda_build.py):
a library is named by a hash of its source, of the ``csrc/`` headers the
source includes (in turn) and of nvcc's flags, so an edit to an included
header builds a new library and an unrelated edit does not. No nvcc is
needed: the key is computed from the files alone."""

import shutil

import pytest

from pytorch_camvid_tpu_torch.ops import cuda_build


@pytest.fixture
def csrc(tmp_path):
    """A copy of the package's csrc/ to edit."""
    dst = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC, dst)
    return dst


@pytest.mark.parametrize("source", ["conv3x3_bn_relu.cu",
                                    "conv3x3_wgrad.cu",
                                    "conv3x3_pair_bn_relu.cu"])
def test_key_covers_the_included_header(csrc, source):
    src = csrc / source
    assert cuda_build.local_includes(src) == [csrc / "sm90_common.cuh"]
    key = cuda_build.build_key(src)
    assert key == cuda_build.build_key(src)   # a pure function of files
    header = csrc / "sm90_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert cuda_build.build_key(src) != key


def test_key_ignores_unrelated_files_and_follows_flags(csrc):
    src = csrc / "conv3x3_bn_relu.cu"
    key = cuda_build.build_key(src)
    other = csrc / "maxpool2x2.cu"   # includes no header of csrc/
    other.write_text(other.read_text() + "\n// edited\n")
    (csrc / "unused.cuh").write_text("// not included\n")
    assert cuda_build.build_key(src) == key
    assert cuda_build.local_includes(other) == []
    assert cuda_build.build_key(src, cuda_build.NVCC_FLAGS + ("-G",)) != key
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.build_key(src) != key


def test_nested_includes_are_followed_once(tmp_path):
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n#include "a.cuh"\n')
    (tmp_path / "b.cuh").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    src = tmp_path / "k.cu"
    src.write_text('#include "a.cuh"\n#include "missing.cuh"\n')
    assert cuda_build.local_includes(src) == [tmp_path / "a.cuh",
                                              tmp_path / "b.cuh"]
    key = cuda_build.build_key(src)
    (tmp_path / "b.cuh").write_text("// edited\n")
    assert cuda_build.build_key(src) != key
