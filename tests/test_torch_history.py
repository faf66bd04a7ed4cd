"""The port's history tiers and codecs against the JAX package.

Codes must agree bitwise: the same seeded numpy rows through each JAX codec
and the port's give the same q and per-leaf scales, and a JAX history
carried across with `TrainingHistory.from_state_dict` decodes every entry
to the same bits in both packages.  The tier and codec errors say what the
reference's say.  The disk tier reads back bitwise what the host tier
holds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from repro.core import deltagrad as jdg
from repro.core.history import CODECS as J_CODECS
from repro.core.history import HistoryMeta as JMeta
from repro.core.history import TrainingHistory as JHistory
from repro.data.synthetic import multiclass_classification as j_multiclass
from repro.models.simple import mlp_objective as j_mlp_objective

from repro_torch.core import deltagrad as tdg
from repro_torch.core.history import CODECS as T_CODECS
from repro_torch.core.history import HistoryMeta as TMeta
from repro_torch.core.history import TrainingHistory as THistory
from repro_torch.core.history import leaf_bounds
from repro_torch.data.synthetic import multiclass_classification as t_multiclass
from repro_torch.models.simple import mlp_objective, params_from_jax

LOSSY = ("bf16", "int8", "delta_bf16", "delta_int8")
CODECS = ("f32",) + LOSSY
SHAPES = {"w1": (20, 32), "b1": (32,), "w2": (32, 4), "b2": (4,)}
LR = ((0, 0.2), (10, 0.1))


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    tree = {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}
    tree["b1"][:] = 0.0  # an all-zero leaf: int8 takes scale 1.0 there
    return tree


def _flat(tree):
    return np.concatenate([np.asarray(tree[k]).reshape(-1) for k in sorted(tree)])


def _jax_codes(enc):
    """(q, scale) of a JAX-encoded tree in the port's flat layout."""
    names = sorted(enc)
    if isinstance(enc[names[0]], dict):
        return (np.concatenate([np.asarray(enc[k]["q"]).reshape(-1) for k in names]),
                np.asarray([enc[k]["scale"] for k in names], np.float32))
    return np.concatenate([np.asarray(enc[k]).reshape(-1).view(np.int16)
                           for k in names]), None


@pytest.mark.parametrize("codec", LOSSY)
def test_codec_encode_matches_jax_bitwise(codec):
    x, base = _tree(1), _tree(2, scale=0.9)
    bounds = leaf_bounds(SHAPES)
    jc, tc = J_CODECS[codec](), T_CODECS[codec]()
    if codec.startswith("delta"):
        jenc = jc.encode_delta(x, base)
        tenc = tc.encode_delta(_flat(x), _flat(base), bounds)
    else:
        jenc = jc.encode(x)
        tenc = tc.encode(_flat(x), bounds)
    q, scale = _jax_codes(jenc)
    assert tenc.q.dtype == q.dtype and np.array_equal(tenc.q, q)
    if scale is None:
        assert tenc.scale is None
    else:
        assert np.array_equal(tenc.scale, scale)
        if not codec.startswith("delta"):
            assert tenc.scale[sorted(SHAPES).index("b1")] == 1.0


# ragged leaves, an empty one, an all-zero one, and leaves whose codes sit
# on ties at .5 (max |x| 127 and 254: scale 1 and 2, x / scale = k + 0.5)
TIE_SHAPES = {"a_ties": (8,), "b_empty": (0,), "c_zero": (7,), "d_ties2": (9,),
              "e_ragged": (50_001,), "f_ragged": (3,)}


def _tie_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a_ties": np.asarray([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5], np.float32),
            "b_empty": np.zeros(0, np.float32), "c_zero": np.zeros(7, np.float32),
            "d_ties2": np.asarray([254, 1, 3, 5, -1, -3, -253, 0.999, 2.5], np.float32),
            "e_ragged": (3.0 * rng.normal(size=50_001)).astype(np.float32),
            "f_ragged": rng.normal(size=3).astype(np.float32)}


@pytest.mark.parametrize("codec", CODECS)
def test_codec_encodes_ties_empty_zero_and_ragged_leaves_as_jax(codec):
    """A row encoded as a torch tensor (on its own device, the recording's
    path) and as a numpy row gives the JAX codec's codes and scales
    bitwise, on ties at .5, empty and all-zero leaves and ragged leaves;
    and a history fed tensor rows (keyframes kept on the device) holds the
    same entries as one fed numpy rows."""
    x, base = _tie_tree(1), _tie_tree(2)
    bounds = leaf_bounds(TIE_SHAPES)
    xf, bf = _flat(x), _flat(base)
    tc = T_CODECS[codec]()
    if codec == "f32":
        got = [tc.encode_tensor(torch.from_numpy(xf), bounds), tc.encode(xf, bounds)]
        q, scale = xf, None
    elif codec.startswith("delta"):
        got = [tc.encode_delta_tensor(torch.from_numpy(xf), torch.from_numpy(bf), bounds),
               tc.encode_delta(xf, bf, bounds)]
        q, scale = _jax_codes(J_CODECS[codec]().encode_delta(x, base))
    else:
        got = [tc.encode_tensor(torch.from_numpy(xf), bounds), tc.encode(xf, bounds)]
        q, scale = _jax_codes(J_CODECS[codec]().encode(x))
    for enc in got:
        assert enc.q.dtype == q.dtype and np.array_equal(enc.q, q)
        if scale is None:
            assert enc.scale is None
        else:
            assert enc.scale.dtype == np.float32
            assert np.array_equal(enc.scale.view(np.int32), scale.view(np.int32))
    if codec == "int8":
        names = sorted(TIE_SHAPES)
        assert got[0].q[bounds[0]:bounds[1]].tolist() == [127, 0, 2, 2, 0, -2, -2, 126]
        assert got[0].q[bounds[3]:bounds[4]].tolist() == [127, 0, 2, 2, 0, -2, -126, 0, 1]
        assert got[0].scale[names.index("c_zero")] == got[0].scale[names.index("b_empty")] == 1.0
    rows = [(_flat(_tie_tree(s)), _flat(_tie_tree(s + 10))) for s in range(5)]
    hists = []
    for as_tensor in (False, True):
        h = THistory(_tmeta(5), tier="host", codec=codec)
        h.set_layout(TIE_SHAPES, "cpu")
        for w, g in rows:
            if as_tensor:
                h.append(torch.from_numpy(w.copy()), torch.from_numpy(g.copy()))
            else:
                h.append(w.copy(), g.copy())
        hists.append(h)
    for t in range(5):
        for a, b in zip(*(h.encoded_entry(t) for h in hists)):
            assert np.array_equal(a.q, b.q)
            assert (a.scale is None) == (b.scale is None)
            if a.scale is not None:
                assert np.array_equal(a.scale, b.scale)


def _jax_history(codec, steps=20, window=8):
    """A host-tier history trained by the JAX package on the small MLP."""
    ds = j_multiclass(n=400, d=20, num_classes=4, seed=5)
    meta = JMeta(n=ds.n, batch_size=128, seed=7, steps=steps, lr_schedule=LR)
    p0 = {k: jnp.asarray(v) for k, v in _tree(6, 0.2).items()}
    _, hist = jdg.sgd_train_with_cache(j_mlp_objective(l2=1e-3), p0, ds, meta,
                                       tier="host", codec=codec, window=window)
    return hist


def _tmeta(steps=20):
    return TMeta(n=400, batch_size=128, seed=7, steps=steps, lr_schedule=LR)


@pytest.mark.parametrize("codec", CODECS)
def test_entries_carried_across_decode_bitwise(codec):
    jh = _jax_history(codec)
    th = THistory.from_state_dict(jh.state_dict(), _tmeta(), device="cpu")
    assert th.tier == "host" and th.codec.name == codec and len(th) == 20
    for t in range(len(th)):
        for j, p in zip(jh.entry(t), th.entry(t)):
            assert p.dtype == torch.float32
            assert np.array_equal(np.asarray(ravel_pytree(j)[0]), p.numpy()), t


def _port_history(tier, codec, steps=20, window=8, spill_dir=None,
                  spill_window=None):
    ds = t_multiclass(n=400, d=20, num_classes=4, seed=5)
    p0 = params_from_jax(_tree(6, 0.2), "cpu")
    return tdg.sgd_train_with_cache(mlp_objective(l2=1e-3), p0, ds,
                                    _tmeta(steps), tier=tier, codec=codec,
                                    spill_dir=spill_dir, window=window,
                                    spill_window=spill_window, device="cpu")


@pytest.mark.parametrize("codec", ("delta_bf16", "delta_int8"))
def test_keyframe_entries_decode_exactly(codec):
    w_star, stacked = _port_history("stacked", "f32")
    w_host, host = _port_history("host", codec)
    assert torch.equal(w_star.flat, w_host.flat)  # recording is unchanged
    K = host.key_interval
    for t in range(len(host)):
        w, g = host.entry(t)
        if t % K == 0:  # the keyframe itself: a zero residual
            assert torch.equal(w, stacked.W[t]) and torch.equal(g, stacked.G[t])
            assert np.array_equal(host.base_entry(t // K)[0],
                                  stacked.W[t].numpy())
        else:
            assert not torch.equal(w, stacked.W[t])


ERRORS = {
    "unknown-tier": (dict(tier="tape"), "unknown history tier"),
    "unknown-codec": (dict(tier="host", codec="int4"), "unknown codec"),
    "lossy-stacked": (dict(tier="stacked", codec="int8"), "tier='host'"),
    "disk-no-dir": (dict(tier="disk"), "spill_dir"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_tier_and_codec_errors_match_reference(case):
    kw, pattern = ERRORS[case]
    with pytest.raises(ValueError, match=pattern) as jerr:
        JHistory(JMeta(n=4, batch_size=4, seed=0, steps=2,
                       lr_schedule=((0, 0.1),)), **kw)
    with pytest.raises(ValueError, match=pattern) as terr:
        THistory(TMeta(n=4, batch_size=4, seed=0, steps=2,
                       lr_schedule=((0, 0.1),)), **kw)
    if case == "lossy-stacked":  # both point to the host tier
        assert "tier='host'" in str(jerr.value) and "tier='host'" in str(terr.value)


@pytest.mark.parametrize("spill_window", [8, 6])
def test_disk_tier_one_npz_per_window_reads_back_host_bitwise(tmp_path,
                                                              spill_window):
    _, host = _port_history("host", "delta_int8")
    _, disk = _port_history("disk", "delta_int8", spill_dir=str(tmp_path),
                            spill_window=spill_window)
    files = sorted(os.listdir(tmp_path))
    assert files == [f"win_{i:07d}.npz"
                     for i in range(-(-20 // spill_window))]
    assert disk.disk_nbytes() == sum(os.path.getsize(tmp_path / f)
                                     for f in files) > 0
    for t in reversed(range(20)):  # out of order: window loads, not a scan
        for a, b in zip(host.encoded_entry(t), disk.encoded_entry(t)):
            assert np.array_equal(a.q, b.q) and np.array_equal(a.scale, b.scale)
        for a, b in zip(host.entry(t), disk.entry(t)):
            assert torch.equal(a, b)
    assert disk.io_write_s > 0 and disk.io_read_s > 0


def test_disk_tier_auto_spill_dir_and_default_window():
    _, disk = _port_history("disk", "int8", window=0, spill_dir="auto")
    assert os.path.isdir(disk.spill_dir)
    assert disk.spill_window == 20  # the stream window: min(T, 32)
    assert os.listdir(disk.spill_dir) == ["win_0000000.npz"]


def test_host_tier_holds_the_codec_ratio_in_host_ram():
    _, f32 = _port_history("host", "f32")
    _, i8 = _port_history("host", "int8")
    _, stacked = _port_history("stacked", "f32")
    assert f32.nbytes() == stacked.nbytes()
    assert 3.5 < f32.nbytes() / i8.nbytes() <= 4.0


@pytest.mark.parametrize("tier", ["stacked", "disk"])
def test_from_state_dict_takes_only_host_tier_states(tmp_path, tier):
    ds = j_multiclass(n=400, d=20, num_classes=4, seed=5)
    meta = JMeta(n=ds.n, batch_size=128, seed=7, steps=6, lr_schedule=LR)
    p0 = {k: jnp.asarray(v) for k, v in _tree(6, 0.2).items()}
    _, jh = jdg.sgd_train_with_cache(j_mlp_objective(l2=1e-3), p0, ds, meta,
                                     tier=tier, spill_dir=str(tmp_path))
    with pytest.raises(ValueError, match="host-tier states"):
        THistory.from_state_dict(jh.state_dict(), _tmeta(6), device="cpu")
