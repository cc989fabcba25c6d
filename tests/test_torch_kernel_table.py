"""PyTorch port: the table of hand-written kernels (``ops/kernels.py``)
against the CUDA sources it names, parsed as text (no GPU, no ``nvcc``):
every ``__global__`` function belongs to one entry, every source is built,
and every entry's C entry point (and every query beside them) is declared in
its source's ``extern "C"`` block with the types the table gives it. Also
the counter store, the check of a profile against the launches, and that
the flash sources use no atomic operation.

This file imports no JAX, so it also runs where only PyTorch is installed."""

import ctypes
import os
import re

import pytest

from medical_image_generation_tpu_torch.ops import _build
from medical_image_generation_tpu_torch.ops import kernels as tk


def _source(name):
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        return f.read()


def _globals():
    """{``__global__`` function name: file} over every file in csrc/."""
    out = {}
    for fname in sorted(os.listdir(_build.CSRC_DIR)):
        pat = r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\("
        for fn in re.findall(pat, _source(fname)):
            out[fn] = fname
    return out


def _extern_c(source):
    """The text of the ``extern "C" { ... }`` blocks of csrc/<source>.cu."""
    return "".join(re.findall(r'extern "C" \{(.*?)\}  // extern "C"', _source(f"{source}.cu"),
                              re.S))


def test_every_global_function_belongs_to_one_entry():
    """Each ``__global__`` function of csrc/ is a device name of exactly one
    entry, every device name of an entry is one of them (in the entry's own
    source), and every entry owns at least one."""
    found = _globals()
    owners = {}
    for k in tk.KERNELS.values():
        assert k.device_names, k
        for dn in k.device_names:
            owners.setdefault(dn, []).append(k.name)
            assert found.get(dn) == f"{k.source}.cu", (k.name, dn)
    assert set(owners) == set(found)
    assert all(len(v) == 1 for v in owners.values()), owners


def test_device_names_are_part_of_no_other_entry():
    """No device name is a substring of another entry's, so a profiler
    event (a demangled or mangled name with template arguments) has one
    owner, and ``owner`` finds it."""
    names = [(dn, k.name) for k in tk.KERNELS.values() for dn in k.device_names]
    for dn, k in names:
        assert [o for d, o in names if dn in d and o != k] == []
        assert tk.owner(f"void (anonymous namespace)::{dn}<float, 4>(float const*, int)") == k
        assert tk.owner(f"_Z{len(dn)}{dn}ILi64EEvPKfi") == k
    assert tk.owner("void at::native::vectorized_elementwise_kernel<4>(int)") is None


def test_sources_are_the_csrc_files():
    """``SOURCES`` (derived from the table) is every csrc/*.cu, once."""
    files = {f[:-3] for f in os.listdir(_build.CSRC_DIR) if f.endswith(".cu")}
    assert len(set(tk.SOURCES)) == len(tk.SOURCES)
    assert set(tk.SOURCES) == files


_C_TYPES = {"int": ctypes.c_int, "long long": ctypes.c_longlong, "float": ctypes.c_float,
            "void": None}


def _declared(source, symbol):
    """(restype, [C parameter type]) of ``symbol``'s definition in an
    ``extern "C"`` block of csrc/<source>.cu; a parameter's type keeps its
    ``*`` and drops ``const`` and its name."""
    m = re.search(rf"\b(int|long long|void)\s+{symbol}\s*\(([^)]*)\)\s*{{",
                  _extern_c(source))
    assert m, f"{symbol} not in csrc/{source}.cu's extern \"C\" block"
    params = [p.replace("const ", "").strip() for p in m.group(2).split(",") if p.strip()]
    return _C_TYPES[m.group(1)], [re.sub(r"\s*\w+$", "", p).replace(" *", "*") for p in params]


def _takes(argtype, c_type):
    """Whether a ctypes argument type passes a C parameter of ``c_type``:
    c_void_p any pointer, POINTER(T) a pointer to T, a scalar its own type."""
    if c_type.endswith("*"):
        base = _C_TYPES.get(c_type[:-1])
        return argtype is ctypes.c_void_p or (base is not None and argtype == ctypes.POINTER(base))
    return argtype is _C_TYPES.get(c_type, object)


def _check_declared(source, symbol, argtypes, restype):
    got_restype, params = _declared(source, symbol)
    assert got_restype is restype, (symbol, got_restype, restype)
    assert len(params) == len(argtypes), (symbol, params, argtypes)
    bad = [(i, p, a) for i, (p, a) in enumerate(zip(params, argtypes)) if not _takes(a, p)]
    assert not bad, (symbol, bad)


@pytest.mark.parametrize("name", list(tk.KERNELS))
def test_entry_point_is_declared_as_the_table_types_it(name):
    """The entry's C symbol is defined in an ``extern "C"`` block of its source,
    returns int (its cudaError_t) and takes the table's argument types."""
    k = tk.KERNELS[name]
    _check_declared(k.source, k.symbol, k.argtypes, ctypes.c_int)


@pytest.mark.parametrize("symbol", list(tk.QUERIES))
def test_query_is_declared_as_the_table_types_it(symbol):
    """Each of ``QUERIES`` is defined in its source's ``extern "C"`` block
    with the table's argument and return types."""
    source, argtypes, restype = tk.QUERIES[symbol]
    _check_declared(source, symbol, argtypes, restype)


def test_type_check_rejects_a_wrong_declaration():
    """The parser behind the two tests above sees a pointer's type and a
    scalar's, so a table that mistypes one fails them."""
    k = tk.KERNELS["gn_affine_act"]
    source, argtypes, restype = tk.QUERIES["medimgen_adamw_layout"]
    with pytest.raises(AssertionError):
        _check_declared(source, "medimgen_adamw_layout", (ctypes.POINTER(ctypes.c_float),), None)
    with pytest.raises(AssertionError):
        _check_declared(source, "medimgen_adamw_layout", argtypes, ctypes.c_int)
    with pytest.raises(AssertionError):
        _check_declared(k.source, k.symbol, (ctypes.c_int, *k.argtypes[1:]), ctypes.c_int)


_FLASH_FILES = sorted(f for f in os.listdir(_build.CSRC_DIR) if f.startswith("flash_"))
_ATOMIC = re.compile(r"\batomic\w*\s*\(|\batom\.|\bred\.")


def _code(text):
    """``text`` without its // and /* */ comments."""
    return re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)


@pytest.mark.parametrize("fname", _FLASH_FILES)
def test_flash_sources_use_no_atomics(fname):
    """The flash kernels sum in fixed orders and use no atomic operation (C
    ``atomic*`` calls, PTX ``atom.`` or ``red.``), so every output is the
    same bits on every run."""
    assert _ATOMIC.findall(_code(_source(fname))) == []


def test_atomic_check_sees_an_atomic():
    """The pattern above finds the C and PTX forms, and not the words
    around them (``shared.``, a comment)."""
    src = "x = 1; // atomicAdd(p, 1)\n/* red.add */ asm(\"ld.shared.f32 %0;\");"
    assert _ATOMIC.findall(_code(src)) == []
    for line in ("atomicAdd(p, 1);", "atomicMax (p, v);", 'asm("atom.add.f32 %0;");',
                 'asm("red.global.add.f32 [%0], %1;");'):
        assert _ATOMIC.findall(_code(line))


def test_counter_store_adds_reads_and_resets():
    """Launches under kernel names, side counts under dotted names;
    ``total`` sums one side count over the kernels; ``reset`` zeroes all; an
    undeclared name raises."""
    saved = {n: tk.read(n) for n in (*tk.KERNELS, *tk.SIDE_COUNTS)}
    try:
        tk.reset()
        tk.add("gn_stats_fold")
        tk.add("flash_attn_fwd.input_copies", 3)
        tk.add("flash_attn_bwd_dq_narrow.input_copies", 5)
        assert tk.launches() == {**dict.fromkeys(tk.KERNELS, 0), "gn_stats_fold": 1}
        assert tk.read("flash_attn_fwd.input_copies") == 3
        assert tk.total("input_copies") == 8 and tk.total("vector_launches") == 0
        with pytest.raises(KeyError):
            tk.add("flash_attention.launches")
        tk.reset()
        assert not any(tk.read(n) for n in (*tk.KERNELS, *tk.SIDE_COUNTS))
    finally:
        for n, v in saved.items():
            tk.add(n, v - tk.read(n))


def _no_events():
    return {dn: 0 for k in tk.KERNELS.values() for dn in k.device_names}


@pytest.mark.parametrize("case", [
    # one GroupNorm affine launch that ran both the scalar and the vector kernel
    ({"gn_affine_act": 1}, {"affine_kernel": 1, "affine_vec_kernel": 1}, {"gn_affine_act": 1}),
    # one wide flash forward that ran both the bf16 and the fp32 instantiation
    ({"flash_attn_fwd": 1}, {"flash_fwd_bf16": 1, "flash_fwd_f32": 1}, {"flash_attn_fwd": 1}),
    # one device name more often than its kernel launched
    ({"gn_stats_fold": 1}, {"stats_partial_kernel": 2, "stats_reduce_fold_kernel": 0},
     {"stats_partial_kernel": 1}),
    ({"flash_attn_fwd_narrow": 0}, {"flash_fwd_narrow_bf16": 1},
     {"flash_fwd_narrow_bf16": 1, "flash_attn_fwd_narrow": 1}),
    # as many events as launches, or fewer (events the profile dropped): none beyond
    ({"gn_stats_fold": 3, "gn_affine_act": 3},
     {"stats_partial_kernel": 3, "stats_reduce_fold_kernel": 3, "affine_vec_kernel": 2}, {}),
])
def test_beyond_launches_finds_events_no_launch_made(case):
    """The profile check: a launch runs each of its kernel's device names at
    most once and ``device_launches`` of them in all, so a profile that shows
    more, by one name or summed over the entry's names, is caught."""
    launches, events, want = case
    assert tk.beyond_launches({**dict.fromkeys(tk.KERNELS, 0), **launches},
                              {**_no_events(), **events}) == want
