"""The port's wire codecs against the JAX package's, byte for byte.

``opendiloco_torch/diloco/compression.py`` over ``opendiloco_torch/native.py``
(numpy bodies) must give the JAX package's payload and meta for every
codec, whether the JAX package runs its native library or its numpy
fallback (forced here the way ``tests/test_native.py`` forces it), and
decode any payload to the JAX package's bits. Inputs come from a numpy
seed: odd sizes, an all-zero block, a tail shorter than a block, values
beyond the fp16 range, and one part long enough for the quantile
codebook's strided sample.

Two exceptions are recorded in ROADMAP.md queue C (C4), both where the
JAX package's native path and its numpy fallback differ from each other
(the port follows the fallback):

- uniform8bit: the native encode returns ``span`` as an f32 (``hi - lo``
  in f32), the fallback as a Python float (``hi - lo`` in double), and
  the native decode rounds a given span to f32 first. The payloads are
  equal and the spans equal once rounded to f32; against the native path
  the uniform8bit cases hold that, and decode metas whose span is an f32.
- quantile8bit: the native codebook interpolates the quantiles in double,
  the fallback through ``np.quantile``; on the 35-value leaf of
  :func:`_state_tree` four codebook entries differ by an ulp (first
  differing payload byte 496, entry 124). The inputs of :data:`INPUTS`
  give equal bytes on both paths and are held to that; the state-tree
  case is held against the fallback only.
"""
import json

import numpy as np
import pytest

from opendiloco_tpu import native as jnative
from opendiloco_tpu.diloco import compression as jcomp
from opendiloco_tpu.diloco import tcp as jtcp
from opendiloco_torch.diloco import compression as tcomp
from opendiloco_torch.diloco import state_io

CODECS = sorted(jcomp._CODECS)
BLOCK = jcomp._BLOCK


def _inputs() -> dict:
    rng = np.random.default_rng(20261017)
    zero_block = rng.standard_normal(3 * BLOCK + 17).astype(np.float32)
    zero_block[BLOCK : 2 * BLOCK] = 0.0
    beyond = (rng.standard_normal(2 * BLOCK + 5) * 3e4).astype(np.float32)
    beyond[::97] = 7e4  # beyond fp16's 65504
    beyond[1::97] = -1.2e5
    return {
        "odd": rng.standard_normal(12345).astype(np.float32),
        "zero_block": zero_block,
        "short_tail": (0.01 * rng.standard_normal(BLOCK + 3)).astype(np.float32),
        "beyond_fp16": beyond,
        "one": np.array([0.75], np.float32),
        "all_zero": np.zeros(BLOCK + 1, np.float32),
        "heavy_long": rng.standard_t(2, 250_001).astype(np.float32),
    }


INPUTS = _inputs()


@pytest.fixture(params=["native", "fallback"])
def jax_path(request, monkeypatch):
    """The JAX package's codecs on its native library, or on its numpy
    fallback."""
    if request.param == "native":
        if not jnative.available():
            pytest.skip("the JAX package's native library is not built here")
    else:
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", True)
    return request.param


def _bytes(payload) -> bytes:
    return bytes(payload)


def _assert_meta(name: str, got: dict, want: dict, jax_path: str) -> None:
    if name == "uniform8bit" and jax_path == "native":
        # C4: the native span is f32, the fallback's a double of the same
        # f32 difference
        assert got["lo"] == want["lo"]
        assert np.float32(got["span"]) == np.float32(want["span"])
        return
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)


@pytest.mark.parametrize("name", CODECS)
def test_encode_bytes_match_jax(name, jax_path):
    for label, x in INPUTS.items():
        jp, jm = jcomp.get_codec(name).encode(x)
        tp, tm = tcomp.get_codec(name).encode(x)
        assert _bytes(tp) == _bytes(jp), (name, label)
        _assert_meta(name, tm, jm, jax_path)


def _f32_span(name: str, meta: dict, jax_path: str) -> dict:
    """C4: against the JAX package's native path, a uniform8bit meta with
    its span rounded to f32 (what its native encode gives and its native
    decode reads)."""
    if name == "uniform8bit" and jax_path == "native":
        return {**meta, "span": float(np.float32(meta["span"]))}
    return meta


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("name", CODECS)
def test_decodes_match_jax_bitwise(name, jax_path):
    """decode, decode_accumulate and decode_into of the JAX package's
    payloads (and of the port's own) equal the JAX package's bit for bit."""
    rng = np.random.default_rng(3)
    jc, tc = jcomp.get_codec(name), tcomp.get_codec(name)
    for label, x in INPUTS.items():
        for payload, meta in (jc.encode(x), tc.encode(x)):
            payload, meta = _bytes(payload), _f32_span(name, meta, jax_path)
            want = np.asarray(jc.decode(payload, x.shape, meta))
            np.testing.assert_array_equal(_bits(tc.decode(payload, x.shape, meta)), _bits(want), err_msg=label)
            base = rng.standard_normal(x.size).astype(np.float32)
            ja, ta = base.copy(), base.copy()
            jc.decode_accumulate(payload, meta, ja)
            tc.decode_accumulate(payload, meta, ta)
            np.testing.assert_array_equal(_bits(ta), _bits(ja), err_msg=label)
            jo, to = np.full(x.size, np.nan, np.float32), np.full(x.size, np.nan, np.float32)
            jc.decode_into(payload, meta, jo)
            tc.decode_into(payload, meta, to)
            np.testing.assert_array_equal(_bits(to), _bits(jo), err_msg=label)
            np.testing.assert_array_equal(_bits(to), _bits(want), err_msg=label)


@pytest.mark.parametrize("name", CODECS)
def test_chunked_encode_matches_jax(name, jax_path):
    """chunk_state + encode_chunk over the pipeline's chunk grid: each
    chunk's bytes equal the JAX package's, and the chunk decodes put
    together equal the whole-tensor decode."""
    jc, tc = jcomp.get_codec(name), tcomp.get_codec(name)
    for label, x in INPUTS.items():
        bounds = tcomp.chunk_bounds(x.size, 5000, align=tc.chunk_align)
        assert bounds == jcomp.chunk_bounds(x.size, 5000, align=jc.chunk_align)
        js, ts = jc.chunk_state(x), tc.chunk_state(x)
        out = np.empty(x.size, np.float32)
        for a, b in zip(bounds[:-1], bounds[1:]):
            jp, jm = jc.encode_chunk(x[a:b], js)
            tp, tm = tc.encode_chunk(x[a:b], ts)
            assert _bytes(tp) == _bytes(jp), (name, label, a)
            _assert_meta(name, tm, jm, jax_path)
            tc.decode_into(_bytes(tp), tm, out[a:b])
        whole_p, whole_m = tc.encode(x)
        np.testing.assert_array_equal(_bits(out), _bits(tc.decode(_bytes(whole_p), x.shape, whole_m)),
                                      err_msg=label)


def test_codec_names_and_unknown_name_error():
    assert sorted(tcomp._CODECS) == CODECS
    for name in CODECS:
        c, j = tcomp.get_codec(name), jcomp.get_codec(name)
        assert (c.name, c.chunk_align, c.wire_align_bytes) == (j.name, j.chunk_align, j.wire_align_bytes)
    with pytest.raises(ValueError) as port_err:
        tcomp.get_codec("int3")
    with pytest.raises(ValueError) as jax_err:
        jcomp.get_codec("int3")
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("density", [None, "0.1", "2", "junk"])
def test_topk_density_reads_the_environment(monkeypatch, density):
    if density is None:
        monkeypatch.delenv("ODTP_TOPK_DENSITY", raising=False)
    else:
        monkeypatch.setenv("ODTP_TOPK_DENSITY", density)
    assert tcomp.topk_density() == jcomp.topk_density()
    x = INPUTS["odd"]
    assert _bytes(tcomp.get_codec("topk").encode(x)[0]) == _bytes(jcomp.get_codec("topk").encode(x)[0])


@pytest.mark.parametrize("name", CODECS)
def test_compress_roundtrip_matches_jax(name):
    x = INPUTS["short_tail"].reshape(-1, 1)
    got = tcomp.compress_roundtrip(x, tcomp.get_codec(name))
    want = np.asarray(jcomp.compress_roundtrip(x, jcomp.get_codec(name)))
    assert got.shape == x.shape and np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("L,n_layer", [(3, 2 * BLOCK), (2, BLOCK), (2, BLOCK + 2), (3, 100)])
def test_split_blockwise4_stacked_matches_jax(L, n_layer, jax_path):
    rng = np.random.default_rng(L * n_layer)
    w = (0.02 * rng.standard_normal((L, n_layer))).astype(np.float32)
    w[0, :BLOCK // 2] = 0.0
    payload, meta = jcomp.get_codec("blockwise4bit").encode(w.reshape(-1))
    got = tcomp.split_blockwise4_stacked(_bytes(payload), meta, L, n_layer)
    want = jcomp.split_blockwise4_stacked(_bytes(payload), meta, L, n_layer)
    if n_layer % BLOCK:
        assert got is None and want is None
        return
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the re-sliced layout is the per-layer packing, bit for bit
    jq, js = jcomp.pack_blockwise4_stacked(w)
    assert np.array_equal(got[0], jq) and np.array_equal(got[1], js)


@pytest.mark.parametrize("env", [None, "none", "blockwise4bit", "uniform8bit"])
@pytest.mark.parametrize("configured", ["none", "fp16", "scaled-fp16", "blockwise8bit"])
def test_state_codec_matches_jax(monkeypatch, env, configured):
    if env is None:
        monkeypatch.delenv("ODTP_STATE_CODEC", raising=False)
    else:
        monkeypatch.setenv("ODTP_STATE_CODEC", env)
    got = state_io.state_codec(tcomp.get_codec(configured))
    assert got.name == jtcp.state_codec(jcomp.get_codec(configured)).name


def _state_tree():
    rng = np.random.default_rng(9)
    return {
        "master": [rng.standard_normal((5, 7)).astype(np.float32), rng.standard_normal(BLOCK + 9).astype(np.float32)],
        "epoch": 3,
        "outer_opt": {"lr": 0.7, "bufs": [np.zeros((2, 3), np.float32)], "steps": np.arange(4, dtype=np.int64)},
        "scalar": np.array(1.5, np.float32),
        "f64": np.linspace(0, 1, 6),
    }


STATE_CODECS = ["none", "fp16", "scaled-fp16", "uniform8bit", "blockwise4bit", "quantile8bit"]


@pytest.mark.parametrize(
    "path,name",
    # quantile8bit's codebook of this tree differs between the JAX
    # package's two paths (C4): it is held against the fallback
    [("native", n) for n in STATE_CODECS if n != "quantile8bit"] + [("fallback", n) for n in STATE_CODECS],
)
def test_state_io_with_codec_matches_tcp(path, name, monkeypatch, tmp_path):
    jax_path = path
    if path == "fallback":
        monkeypatch.setattr(jnative, "_lib", None)
        monkeypatch.setattr(jnative, "_tried", True)
    elif not jnative.available():
        pytest.skip("the JAX package's native library is not built here")
    tree = _state_tree()
    jmeta, jblob = jtcp.serialize_state(tree, jcomp.get_codec(name))
    tmeta, tblob = state_io.serialize_state(tree, tcomp.get_codec(name))
    assert tblob == jblob
    if name == "uniform8bit" and jax_path == "native":
        for te, je in zip(tmeta["enc"], jmeta["enc"]):
            assert (te is None) == (je is None)
            if te is not None:
                _assert_meta(name, te["meta"], je["meta"], jax_path)
        # from here on both read metas whose spans are f32 (C4)
        enc = [e and {**e, "meta": _f32_span(name, e["meta"], jax_path)} for e in tmeta["enc"]]
        jmeta = tmeta = {**tmeta, "enc": enc}
    assert json.dumps(tmeta) == json.dumps(jmeta)
    # each package reads the other's payload to the same leaves
    for got in (state_io.deserialize_state(jmeta, jblob), jtcp.deserialize_state(tmeta, tblob)):
        want = jtcp.deserialize_state(jmeta, jblob)
        assert got["epoch"] == want["epoch"] and got["outer_opt"]["lr"] == want["outer_opt"]["lr"]
        for a, b in zip([*got["master"], got["scalar"], got["f64"]], [*want["master"], want["scalar"], want["f64"]]):
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        assert np.array_equal(got["outer_opt"]["steps"], want["outer_opt"]["steps"])
    # a file read array by array gives the same tree
    path = tmp_path / "state.bin"
    path.write_bytes(tblob)
    with open(path, "rb") as f:
        read = state_io.read_state(tmeta, f)
    for a, b in zip(read["master"], state_io.deserialize_state(tmeta, tblob)["master"]):
        assert np.array_equal(a, b)
