"""The port's rule table (``repro_torch.parallel.sharding``) against the
reference's, spec for spec, at full shapes with no processes.

The reference resolves its rules on ``jax.sharding.AbstractMesh``es of 16
x 16 and 2 x 16 x 16 (as ``tests/test_sharding.py`` does); the port on
the same axis sizes.  Its per-layer tree maps onto the reference's
stacked one (layer ``li`` of a pattern unit is ``units/slot{li % P}``
with a leading unit dim, whose spec entry is ``None`` and is dropped; a
remainder layer is ``rem/{i}``).  Held: every param leaf of all ten archs
under all four strategies, the batch of ``train_4k`` (256 rows) and
``long_500k``'s one-row token under every strategy, and the decode states
of ``decode_32k`` and ``long_500k`` (where applicable) under both KV
layouts; zero mismatches, and the leaves' shapes equal.  Also: placements
of a spec, the refusals of a duplicated axis and of axes out of the
mesh's order.
"""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs.base import SHAPES as JAX_SHAPES  # noqa: E402
from repro.models.model import Model as JaxModel  # noqa: E402
from repro.models.model import input_specs as jax_input_specs  # noqa: E402
from repro.models.transformer import ModelOptions as JaxOptions  # noqa: E402
from repro.parallel import sharding as ref  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_arch, shape_applicable  # noqa: E402
from repro_torch.models.model import Model, input_specs  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402


def _abstract(*pairs):
    try:
        return AbstractMesh(tuple(pairs))
    except TypeError:
        return AbstractMesh(tuple(s for _, s in pairs), tuple(n for n, _ in pairs))


MESHES = {
    "16x16": ({"data": 16, "model": 16}, _abstract(("data", 16), ("model", 16))),
    "2x16x16": ({"pod": 2, "data": 16, "model": 16},
                _abstract(("pod", 2), ("data", 16), ("model", 16))),
}


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return JaxModel(jax_get_arch(arch), JaxOptions()).param_shapes()


def _ref_flat(shardings):
    """Reference path -> spec tuple."""
    flat = jax.tree_util.tree_flatten_with_path(shardings)[0]
    return {ref._path_str(path): tuple(sh.spec) for path, sh in flat}


def _ref_shape_flat(tree):
    return {ref._path_str(path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _ref_path(cfg, path):
    """The port's ``layers/<li>/...`` -> (the reference's path, stacked)."""
    parts = path.split("/")
    if parts[0] != "layers":
        return path, False
    li, rest = int(parts[1]), "/".join(parts[2:])
    p, units = len(cfg.block_pattern), cfg.n_pattern_units
    if li < units * p:
        return f"units/slot{li % p}/{rest}", True
    return f"rem/{li - units * p}/{rest}", False


def _mismatches(cfg, port_tree, port_specs, ref_specs, ref_shapes):
    """Leaves whose spec or shape differs; every reference leaf covered."""
    bad, seen = [], set()
    leaves = dict(sharding.leaves_with_paths(port_tree))
    for path, spec in sharding.leaves_with_paths(port_specs):
        rpath, stacked = _ref_path(cfg, path)
        seen.add(rpath)
        want, shape = ref_specs[rpath], ref_shapes[rpath]
        if stacked:
            if want[0] is not None:
                bad.append((path, "stacked unit dim sharded", want))
            want, shape = want[1:], shape[1:]
        if tuple(leaves[path].shape) != shape:
            bad.append((path, tuple(leaves[path].shape), shape))
        if tuple(spec) != want:
            bad.append((path, tuple(spec), want))
    missing = set(ref_specs) - seen
    return bad + [(p, "not in the port's tree") for p in sorted(missing)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_specs_equal_the_reference(arch):
    cfg = get_arch(arch)
    shapes = Model(cfg, device="meta").param_shapes()
    ref_shapes = _ref_shape_flat(_ref_params(arch))
    n_sharded = 0
    for label, (sizes, amesh) in MESHES.items():
        for strategy in sharding.STRATEGIES:
            want = _ref_flat(ref.param_specs(_ref_params(arch), amesh, strategy))
            got = sharding.param_specs(shapes, sizes, strategy)
            assert _mismatches(cfg, shapes, got, want, ref_shapes) == [], (label, strategy)
            n_sharded += sum(any(e is not None for e in s)
                             for _, s in sharding.leaves_with_paths(got))
    assert n_sharded > 0


@pytest.mark.parametrize("arch", list(ARCHS))
def test_state_specs_equal_the_reference(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    held = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not shape_applicable(cfg, shape)[0]:
            continue
        states = input_specs(cfg, shape)["states"]
        ref_states = jax_input_specs(jcfg, JAX_SHAPES[shape_name])["states"]
        ref_shapes = _ref_shape_flat(ref_states)
        for label, (sizes, amesh) in MESHES.items():
            for kv in ("heads", "seq"):
                want = _ref_flat(ref.state_specs(ref_states, amesh, shape.global_batch,
                                                 kv_layout=kv))
                got = sharding.state_specs(states, sizes, shape.global_batch, kv_layout=kv)
                assert _mismatches(cfg, states, got, want, ref_shapes) == [], (
                    shape_name, label, kv)
                held += 1
    assert held >= 4


def test_batch_specs_equal_the_reference():
    for arch in ARCHS:
        cfg, jcfg = get_arch(arch), jax_get_arch(arch)
        train = input_specs(cfg, SHAPES["train_4k"])
        ref_train = jax_input_specs(jcfg, JAX_SHAPES["train_4k"])
        one = {"token": input_specs(cfg, SHAPES["long_500k"])["token"]} if (
            shape_applicable(cfg, SHAPES["long_500k"])[0]) else {
            "token": torch.empty((1, 1), dtype=torch.int32, device="meta")}
        ref_one = {"token": jax.ShapeDtypeStruct(tuple(one["token"].shape), jax.numpy.int32)}
        assert train["tokens"].shape[0] == 256 and one["token"].shape[0] == 1
        for sizes, amesh in MESHES.values():
            for strategy in sharding.STRATEGIES:
                for mine, theirs in ((train, ref_train), (one, ref_one)):
                    got = dict(sharding.leaves_with_paths(
                        sharding.batch_specs(mine, sizes, strategy)))
                    want = _ref_flat(ref.batch_specs(theirs, amesh, strategy))
                    assert {k: tuple(v) for k, v in got.items()} == want, (arch, strategy)
                    if mine is one:
                        assert all(e is None for e in got["token"])  # one row: replicated


def test_placements_and_refusals():
    from torch.distributed.tensor import Replicate, Shard

    sizes = {"pod": 2, "data": 16, "model": 16}
    assert sharding.placements(sharding.Spec(("data", "model"), None), sizes) == (
        Replicate(), Shard(0), Shard(0))
    assert sharding.placements(sharding.Spec(None, "model", ("pod", "data")), sizes) == (
        Shard(2), Shard(2), Shard(1))
    with pytest.raises(ValueError, match="used twice"):  # the reference's activation bug
        sharding.placements(sharding.Spec("data", None, "data"), sizes)
    with pytest.raises(ValueError, match="out of the mesh's order"):
        sharding.placements(sharding.Spec(("model", "data")), sizes)
    # the guard: a dim the axes do not divide stays whole
    assert tuple(sharding._guard(sizes, ("data", "model"), (24, 32))) == (None, "model")
    # tree_shardings: the reference's dispatch by kind, default strategy
    shapes = Model(get_arch("qwen1.5-0.5b"), device="meta").param_shapes()
    assert (dict(sharding.leaves_with_paths(sharding.tree_shardings(shapes, sizes, "params")))
            == dict(sharding.leaves_with_paths(sharding.param_specs(shapes, sizes))))
    with pytest.raises(ValueError):
        sharding.tree_shardings(shapes, sizes, "activations")
    x = torch.arange(64.0).reshape(8, 8)
    blk = sharding.local_block(x, sharding.Spec(("data", "model"), None),
                               {"data": 2, "model": 2}, {"data": 1, "model": 0})
    assert torch.equal(blk, x[4:6])
