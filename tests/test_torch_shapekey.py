"""The port's shape generalization (``repro_torch.core.shapekey`` and
``ForgeCompiler.compile_bucketed``) against the JAX package's: bucket
policies agree extent by extent, ladder overflow raises in both, and a
bucketed front compiles one program per bucket and none on a repeat.
"""
import numpy as np
import pytest
import torch

from repro.core import shapekey as jsk
from repro_torch.core import ForgeCompiler, PolyAxis
from repro_torch.core import shapekey as sk

POLICIES = ["exact", "pow2", "ladder:1,2,4,8,16,32,64,128,256",
            "ladder:16,32,64,128,256", "ladder:3,7,300"]


def _bucket_or_raise(policy, n):
    try:
        return policy.bucket(n)
    except ValueError:
        return "raises"


@pytest.mark.parametrize("spec", POLICIES)
def test_bucket_policies_match_jax(spec):
    """Extent by extent over n in [1, 300]: the same bucket, or both raise
    (past a ladder's top rung)."""
    mine, ref = sk.get_bucket_policy(spec), jsk.get_bucket_policy(spec)
    assert mine.name == ref.name
    for n in range(1, 301):
        assert _bucket_or_raise(mine, n) == _bucket_or_raise(ref, n), (spec, n)


@pytest.mark.parametrize("spec,n", [("ladder:16,32,64", 65), ("ladder:4", 5)])
def test_ladder_overflow_raises_in_both(spec, n):
    for mod in (sk, jsk):
        with pytest.raises(ValueError, match="exceeds top ladder rung"):
            mod.get_bucket_policy(spec).bucket(n)


def test_bad_specs_rejected():
    for bad in ("pow3", "ladder:8,4", "ladder:x"):
        with pytest.raises(ValueError):
            sk.get_bucket_policy(bad)
    with pytest.raises(ValueError):
        sk.Pow2Policy().bucket(0)


def test_pow2_max_bucket_matches_jax():
    mine, ref = sk.Pow2Policy(max_bucket=12), jsk.Pow2Policy(max_bucket=12)
    for n in range(1, 13):
        assert mine.bucket(n) == ref.bucket(n)
    with pytest.raises(ValueError):
        mine.bucket(13)


def test_shape_key_is_immutable_and_hashable():
    k = sk.ShapeKey((sk.AxisKey("pow2", 4, "B"), sk.AxisKey("ladder", 64, "S")))
    assert str(k) == "pow2:B4xladder:S64" == str(
        jsk.ShapeKey((jsk.AxisKey("pow2", 4, "B"), jsk.AxisKey("ladder", 64, "S"))))
    assert k.extents == (4, 64) and k == sk.ShapeKey(k.axes) and len({k, k}) == 1
    with pytest.raises(AttributeError):
        k.axes = ()
    with pytest.raises(ValueError):
        sk.ShapeKey(())


def test_flatten_axes_follows_torch_dict_order():
    tree = ({"w": torch.zeros(2), "a": torch.zeros(3)}, torch.zeros(4, 5))
    assert sk.flatten_axes((None, 0), tree) == [None, None, 0]
    assert sk.flatten_axes(({"w": 0, "a": None}, 1), tree) == [0, None, 1]
    with pytest.raises(ValueError):
        sk.flatten_axes((0,), tree)
    with pytest.raises(ValueError):
        sk.flatten_axes({"w": 0}, tree)  # a dict spec over a tuple node


def test_infer_extents_and_mismatch():
    leaves = [torch.zeros(3, 7), torch.zeros(3), torch.zeros(5)]
    tree = tuple(leaves)
    assert sk.infer_extent(leaves, sk.flatten_axes((0, 0, None), tree)) == 3
    assert sk.infer_extent(leaves, sk.flatten_axes((1, None, None), tree)) == 7
    with pytest.raises(ValueError, match="inconsistent"):
        sk.infer_extent(leaves, [0, 0, 0])
    with pytest.raises(ValueError, match="marks no leaf"):
        sk.infer_extent(leaves, [None, None, None])


def _step(x, w, bias):
    return torch.relu(x @ w + bias), x * 2.0


def _padded(B, rng):
    """A bucket-shaped batch: B real rows edge-padded to the pow2 bucket."""
    x = torch.from_numpy(rng.standard_normal((B, 6)).astype(np.float32))
    ext = sk.Pow2Policy().bucket(B)
    return x, torch.cat([x, x[-1:].expand(ext - B, 6)])


def test_compile_bucketed_one_program_per_bucket():
    w, bias = torch.randn(6, 4), torch.randn(4)
    front = ForgeCompiler().compile_bucketed(_step, in_axes=(0, None, None), policy="pow2")
    rng = np.random.default_rng(2)
    for B in (1, 2, 3, 4, 5, 3, 1, 8):
        x, xp = _padded(B, rng)
        mod, key, n = front.program_for(xp, w, bias)
        assert n == key.extents[0] == xp.shape[0]
        y, z = mod(xp, w, bias)
        front.stats.note_dispatch(key, B, n)
        torch.testing.assert_close(y[:B], torch.relu(x @ w + bias))
        torch.testing.assert_close(z[:B], x * 2.0)
    assert sorted(str(k) for k in front.programs) == ["pow2:B2", "pow2:B4", "pow2:B8"]
    assert front.stats.compiles == 3 and front.stats.bucket_hits == 5
    assert front.stats.calls == 8
    assert front.stats.rows_real == 27 and front.stats.rows_padded == 7
    compiles = front.stats.compiles
    front.program_for(_padded(7, rng)[1], w, bias)  # a repeat of bucket 8: no compile
    assert front.stats.compiles == compiles
    key = front.key_for_extents(8)
    assert front.lookup_program(key) is front.programs[key]
    assert front.programs[key].result.shape_key == "pow2:B8"
    assert front.stats.per_bucket_calls == {"pow2:B2": 3, "pow2:B4": 3, "pow2:B8": 2}


def test_compile_bucketed_two_axes():
    front = ForgeCompiler().compile_bucketed(
        lambda t, s: (t * 3.0, s + 1.0),
        torch.zeros(2, 8), torch.zeros(2),
        axes=(PolyAxis(in_axes=(0, 0), policy="pow2", label="B"),
              PolyAxis(in_axes=(1, None), policy="ladder:8,16", label="S")),
    )
    assert [str(k) for k in front.programs] == ["pow2:B2xladder:S8"]  # warmed eagerly
    t = torch.randn(4, 16)
    mod, key, n = front.program_for(t, torch.ones(4))
    assert str(key) == "pow2:B4xladder:S16" and n == (4, 16)
    a, b = mod(t, torch.ones(4))
    torch.testing.assert_close(a, t * 3.0)
    torch.testing.assert_close(b, torch.full((4,), 2.0))
    assert front.shape_key_for(torch.randn(3, 11), torch.ones(3))[1] == (3, 11)
    assert front.key_for_extents((4, 16)) == key
    with pytest.raises(ValueError, match="expected 2 extents"):
        front.key_for_extents(4)


def test_program_for_rejects_unpadded_extents():
    """A front holds no pad-and-mask plan: its caller pads to the bucket,
    so arguments off the bucket extents raise, on a miss and on a hit."""
    w, bias = torch.randn(6, 4), torch.randn(4)
    front = ForgeCompiler().compile_bucketed(_step, torch.zeros(4, 6), w, bias,
                                             in_axes=(0, None, None))
    for B in (3, 5):
        with pytest.raises(ValueError, match="not the bucket extents"):
            front.program_for(torch.zeros(B, 6), w, bias)
    assert [str(k) for k in front.programs] == ["pow2:B4"]


@pytest.mark.parametrize("prime", [False, True])
def test_prime_compiles_nested_forge_bodies_first(prime):
    """A step that calls a Forge-compiled body cannot compile that body
    inside its own capture; ``prime`` runs the step once eagerly first,
    so the capture traces through the body's executor."""
    from repro_torch.models import _forge

    def body(x, w):
        return torch.tanh(x @ w)

    def step(x, w):
        inner = _forge.forge_body(body, f"test_prime/{prime}", (x, w))
        return inner(x, w) + 1.0

    x, w = torch.randn(2, 6), torch.randn(6, 6)
    front = ForgeCompiler().compile_bucketed(step, in_axes=(0, None), prime=prime)
    try:
        if prime:
            mod, _, _ = front.program_for(x, w)
            torch.testing.assert_close(mod(x, w), torch.tanh(x @ w) + 1.0)
        else:
            with pytest.raises(Exception):
                front.program_for(x, w)
            assert not front.programs
    finally:
        for k in [k for k in _forge._CACHE if k.startswith("test_prime/")]:
            del _forge._CACHE[k]
