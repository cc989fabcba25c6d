"""PyTorch port, host IO: the port's VolStore against the JAX package's
(each reads what the other writes, bit for bit, with the native zstd codec
and with the zlib fallback; out-of-bounds, fully outside and concurrent
bbox reads), the per-patient properties pickle, the ``.pt`` checkpoint
and ``loss_dict.pkl`` helpers, NIfTI files (each package reads what the
other writes: decoded data, affine and spacing) and the port's PNG
writer."""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

from medical_image_generation_tpu.io import nifti as jnifti
from medical_image_generation_tpu.io import volstore as jvs
from medical_image_generation_tpu.planning import preprocess as jpre
from medical_image_generation_tpu.training import checkpoints as jckpt
from medical_image_generation_tpu_torch.io import nifti as tnifti
from medical_image_generation_tpu_torch.io import png as tpng
from medical_image_generation_tpu_torch.io import volstore as tvs
from medical_image_generation_tpu_torch.planning import preprocess as tpre
from medical_image_generation_tpu_torch.training import checkpoints as tckpt

# (array shape, chunk shape or None for the default (1, 1, Y, X), dtype)
VOLUMES = [
    ((1, 12, 24, 24), None, np.float32),
    ((2, 7, 10, 13), (1, 3, 4, 5), np.float32),
    ((9, 15, 17), (1, 15, 17), np.uint8),
    ((3, 5, 6, 7), (2, 2, 3, 7), np.int16),
]
BOXES = [  # (lbs, ubs) relative to the array shape: inside, overhanging, fully outside
    (lambda s: [0] * len(s), lambda s: list(s)),
    (lambda s: [-1] * len(s), lambda s: [d + 2 for d in s]),
    (lambda s: [0] + [d // 3 for d in s[1:]], lambda s: [1] + [d // 3 + 4 for d in s[1:]]),
    (lambda s: [0] + [d + 1 for d in s[1:]], lambda s: [1] + [d + 5 for d in s[1:]]),
    (lambda s: [-6] * len(s), lambda s: [-1] * len(s)),
]


def _array(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.integer):
        return rng.integers(0, 100, size=shape).astype(dtype)
    return rng.normal(size=shape).astype(dtype)


def _no_native(monkeypatch, *mods):
    for m in mods:
        monkeypatch.setattr(m, "_lib", None)
        monkeypatch.setattr(m, "_lib_failed", True)


@pytest.mark.parametrize("codec", ["zstd", "zlib"])
@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("vol", range(len(VOLUMES)))
def test_volstore_cross_package_reads(tmp_path, monkeypatch, codec, writer, vol):
    """A file written by one package reads back bit for bit through the
    other, whole and through every box of BOXES, equal to the JAX reader."""
    shape, chunk, dtype = VOLUMES[vol]
    if codec == "zlib":
        _no_native(monkeypatch, jvs, tvs)
    arr = _array(shape, dtype, vol)
    path = str(tmp_path / "v.vs")
    (jvs if writer == "jax" else tvs).write_volume(path, arr, chunk_shape=chunk)
    with open(path, "rb") as f:
        assert f.read(8) == b"MIGVS01\x00"
    j, t = jvs.VolStore(path), tvs.VolStore(path)
    assert t.codec.startswith(codec) and (t.shape, t.chunk_shape) == (j.shape, j.chunk_shape)
    if not (writer == "jax" and codec == "zstd" and _splits_last_axis(shape, chunk)):
        np.testing.assert_array_equal(t.read_full(), arr)  # else see the test below
        np.testing.assert_array_equal(t[0, 1:3], arr[0, 1:3])
    for lo, hi in BOXES:
        lbs, ubs = lo(shape), hi(shape)
        got, ref = t.read_bbox(lbs, ubs), j.read_bbox(lbs, ubs)
        assert got.dtype == ref.dtype and got.shape == tuple(u - l for l, u in zip(lbs, ubs))
        np.testing.assert_array_equal(got, ref)


def _splits_last_axis(shape, chunk):
    return chunk is not None and chunk[-1] < shape[-1]


def test_jax_native_writer_fault_on_chunks_that_split_the_last_axis(tmp_path):
    """The JAX package's native writer adds the innermost chunk origin
    twice (io/native/volcodec.cpp, gather_chunk_from_array), so chunks that
    split the last axis store the wrong voxels; the default (1, 1, Y, X)
    chunks never split it. The port's copy adds it once: its files read back
    exactly through either package's reader."""
    arr = _array((2, 7, 10, 13), np.float32, 1)
    jvs.write_volume(str(tmp_path / "j.vs"), arr, chunk_shape=(1, 3, 4, 5))
    tvs.write_volume(str(tmp_path / "t.vs"), arr, chunk_shape=(1, 3, 4, 5))
    assert not np.array_equal(jvs.VolStore(str(tmp_path / "j.vs")).read_full(), arr)
    for m in (jvs, tvs):
        np.testing.assert_array_equal(m.VolStore(str(tmp_path / "t.vs")).read_full(), arr)


def test_volstore_files_byte_identical_per_codec(tmp_path, monkeypatch):
    """The same array, written by each package with the same codec, gives
    the same bytes (metadata, chunk table and payload)."""
    arr = _array((1, 6, 20, 22), np.float32, 9)
    for codec in ("zstd", "zlib"):
        if codec == "zlib":
            _no_native(monkeypatch, jvs, tvs)
        jvs.write_volume(str(tmp_path / f"j_{codec}.vs"), arr)
        tvs.write_volume(str(tmp_path / f"t_{codec}.vs"), arr)
        assert (tmp_path / f"j_{codec}.vs").read_bytes() == \
            (tmp_path / f"t_{codec}.vs").read_bytes(), codec


def test_volstore_zstd_file_without_native_codec_raises(tmp_path, monkeypatch):
    path = str(tmp_path / "z.vs")
    tvs.write_volume(path, _array((1, 4, 8, 8), np.float32, 3))
    _no_native(monkeypatch, tvs)
    with pytest.raises(RuntimeError, match="native codec is unavailable"):
        tvs.VolStore(path).read_full()


def test_volstore_concurrent_bbox_reads(tmp_path):
    """The prefetch loader reads one store from many threads."""
    arr = _array((1, 16, 64, 64), np.float32, 8)
    path = str(tmp_path / "c.vs")
    jvs.write_volume(path, arr, chunk_shape=(1, 1, 64, 64))
    vs = tvs.open_volume(path)

    def read(i):
        z = i % 12
        got = vs.read_bbox([0, z - 2, 3, 0], [1, z + 4, 67, 64])
        expected = np.zeros((1, 6, 64, 64), np.float32)
        lo = max(z - 2, 0)
        expected[:, lo - (z - 2):, :61] = arr[:, lo:z + 4, 3:]
        np.testing.assert_array_equal(got, expected)
        return True

    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        assert all(ex.map(read, range(64)))


def test_volstore_library_is_built_beside_the_package():
    """The codec is built on first use under build/torch_host, named by a
    hash of its source and flags, from the port's own copy of the source."""
    assert tvs.codec_in_use().startswith("zstd (native")
    path = tvs.lib_path()
    assert os.path.dirname(path) == tvs.BUILD_DIR and os.path.exists(path)
    assert os.path.basename(os.path.dirname(tvs.BUILD_DIR)) == "build"
    src = os.path.join(os.path.dirname(tvs.__file__), "native", "volcodec.cpp")
    jsrc = os.path.join(os.path.dirname(jvs.__file__), "native", "volcodec.cpp")
    body, jbody = open(src).read(), open(jsrc).read()
    api = 'extern "C" {'
    assert body[body.rindex(api):] == jbody[jbody.rindex(api):]  # the same C API


def test_volstore_codec_builds_without_the_zstd_header(tmp_path, monkeypatch):
    """The codec is built with its own declarations of the zstd functions,
    linked to the runtime library libzstd.so.1 (no zstd.h needed), under a
    name keyed on the host's resolved -march=native target; that build
    writes files the JAX package reads, and reads the JAX package's."""
    import ctypes

    src = open(os.path.join(os.path.dirname(tvs.__file__), "native", "volcodec.cpp")).read()
    assert "#include <zstd.h>" not in src and "ZSTD_decompress(void* dst" in src
    assert tvs.link_flags()[0].startswith("-l:libzstd.so")
    assert "-march=" in tvs.host_target()
    path = tvs.lib_path()
    monkeypatch.setattr(tvs, "host_target", lambda: "-march= some-other-cpu")
    assert tvs.lib_path() != path  # a library built for another CPU is not picked up
    out = str(tmp_path / "libvolcodec-test.so")
    assert tvs._build_native(out) is None
    monkeypatch.setattr(tvs, "_lib", tvs._bind(ctypes.CDLL(out)))
    arr = _array((1, 9, 20, 22), np.float32, 11)
    tvs.write_volume(str(tmp_path / "t.vs"), arr)
    jvs.write_volume(str(tmp_path / "j.vs"), arr)
    np.testing.assert_array_equal(jvs.VolStore(str(tmp_path / "t.vs")).read_full(), arr)
    np.testing.assert_array_equal(tvs.VolStore(str(tmp_path / "j.vs")).read_bbox(
        [0, -2, 3, 4], [1, 5, 18, 30]), jvs.VolStore(str(tmp_path / "j.vs")).read_bbox(
        [0, -2, 3, 4], [1, 5, 18, 30]))


def test_properties_cross_package(tmp_path):
    props = {"class_locations": {1: [(2, 3, 4), (5, 6, 7)], 2: []}, "min_max": [(0.0, 1.0)]}
    tpre.save_properties(str(tmp_path), "p0", props)
    assert jpre.load_properties(str(tmp_path), "p0") == props
    jpre.save_properties(str(tmp_path), "p1", props)
    assert tpre.load_properties(str(tmp_path), "p1") == props


def test_checkpoint_roundtrip_is_atomic(tmp_path):
    payload = {"epoch": 3, "unet": {"w": torch.arange(6.0).reshape(2, 3)},
               "opt_state": {"mu": {"w": torch.ones(2, dtype=torch.bfloat16)}, "count": 7,
                             "mini_step": 0},
               "latent_shape": [1, 2], "validation_loss": 0.5,
               "generators": {"host": torch.Generator().manual_seed(1).get_state()}}
    path = tckpt.save_checkpoint(str(tmp_path), "last_model", payload)
    assert path == str(tmp_path / "last_model.pt") and os.listdir(tmp_path) == ["last_model.pt"]
    back = tckpt.load_checkpoint(path)
    assert back["epoch"] == 3 and back["opt_state"]["count"] == 7
    assert torch.equal(back["unet"]["w"], payload["unet"]["w"])
    assert back["opt_state"]["mu"]["w"].dtype == torch.bfloat16
    assert torch.equal(back["generators"]["host"], payload["generators"]["host"])


def test_loss_dict_cross_package(tmp_path):
    losses = {"rec_loss": [1.0, 0.5], "val_rec_loss": [1.1, 0.6]}
    tckpt.save_loss_dict(str(tmp_path), losses)
    assert jckpt.load_loss_dict(str(tmp_path)) == losses
    assert tckpt.load_loss_dict(str(tmp_path / "missing")) is None


# ---------------------------------------------------------------------- NIfTI

NIFTI = [  # (shape, dtype, affine or None, file name)
    ((12, 10, 8), np.float32, None, "a.nii.gz"),
    ((7, 6, 5, 2), np.float32, np.diag([0.8, 1.2, 2.5, 1.0]), "b.nii.gz"),
    ((9, 4, 3), np.int16, np.array([[0.0, -1.5, 0.0, 10.0], [2.0, 0.0, 0.0, -4.0],
                                    [0.0, 0.0, 3.0, 7.5], [0.0, 0.0, 0.0, 1.0]]), "c.nii"),
    ((5, 5, 5), np.uint8, np.diag([1.0, 1.0, 1.0, 1.0]), "d.nii.gz"),
]


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", range(len(NIFTI)))
def test_nifti_cross_package(tmp_path, writer, case):
    """A volume written by either package reads back equal in the other:
    the decoded array (dtype and Fortran order), the sform affine and the
    spacing, from the whole file and from the header alone."""
    shape, dtype, affine, name = NIFTI[case]
    data = _array(shape, dtype, seed=case)
    path = str(tmp_path / name)
    (jnifti if writer == "jax" else tnifti).save_nifti(path, data, affine)
    reader = tnifti if writer == "jax" else jnifti
    img = reader.load_nifti(path)
    np.testing.assert_array_equal(img.data, data)
    assert img.data.dtype == data.dtype
    want = np.eye(4) if affine is None else affine
    np.testing.assert_allclose(img.affine, want, rtol=0, atol=1e-6)
    spacing = np.sqrt(np.sum(want[:3, :3] ** 2, axis=0))
    np.testing.assert_allclose(img.spacing, spacing, rtol=1e-6)
    np.testing.assert_allclose(reader.extract_spacing(path), spacing, rtol=1e-6)
    np.testing.assert_allclose(tnifti.extract_spacing(path), jnifti.extract_spacing(path))


def test_nifti_scaling_and_qform_equal_jax(tmp_path):
    """scl_slope / scl_inter and a qform-only header decode the same in both
    readers."""
    import struct

    path = str(tmp_path / "q.nii")
    tnifti.save_nifti(path, np.arange(24, dtype=np.int16).reshape(2, 3, 4))
    raw = bytearray(open(path, "rb").read())
    struct.pack_into("<f", raw, 112, 0.5)  # scl_slope
    struct.pack_into("<f", raw, 116, -3.0)  # scl_inter
    struct.pack_into("<h", raw, 252, 1)  # qform_code
    struct.pack_into("<h", raw, 254, 0)  # sform_code
    struct.pack_into("<3f", raw, 256, 0.1, 0.2, 0.3)
    struct.pack_into("<3f", raw, 268, 5.0, 6.0, 7.0)
    open(path, "wb").write(bytes(raw))
    t, j = tnifti.load_nifti(path), jnifti.load_nifti(path)
    assert t.data.dtype == np.float32
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.affine, j.affine)
    np.testing.assert_array_equal(tnifti.extract_spacing(path), jnifti.extract_spacing(path))


# ------------------------------------------------------------------------ PNG


def test_png_roundtrip_and_grid(tmp_path):
    """The port's PNG writer: 8-bit grayscale that ``read_png`` (and PIL,
    where installed) reads back; samples min-max scaled; a grid of four to a
    row with 2-pixel gaps."""
    img = np.random.default_rng(0).uniform(0.2, 0.7, (37, 53, 1)).astype(np.float32)
    u8 = tpng.to_uint8(img)
    assert u8.shape == (37, 53) and u8.min() == 0 and u8.max() == 255
    path = str(tmp_path / "x.png")
    tpng.write_png(path, u8)
    np.testing.assert_array_equal(tpng.read_png(path), u8)
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        np.testing.assert_array_equal(np.asarray(Image.open(path)), u8)
    grid = tpng.image_grid([img] * 6)
    assert grid.shape == (2 * 37 + 2, 4 * 53 + 6)
    np.testing.assert_array_equal(grid[39:, 55:108], u8)
    assert not grid[37:39].any() and not grid[39:, 212 - 6 + 2:].any()
    assert not tpng.to_uint8(np.full((4, 4), 0.3)).any()
