"""Device (XLA) phyloP LRT vs the numpy fit (hal_tpu.phylop) — same
golden-section schedule, float64 host re-evaluation at the fitted scales,
shared postprocessing.  Runs on the CPU backend here; the program is the
one an accelerator executes.

Small synthetic trees keep the unrolled-pruning compiles fast; one seeded
10-leaf .mod case checks the realistic program."""

import numpy as np
import pytest

from hal_tpu.phylop import (NeutralModel, PhyloPScorer, random_mod_text,
                            score_patterns)


def _gtr(bg, s_ts=2.0):
    S = np.ones((4, 4)) - np.eye(4)
    S[0, 2] = S[2, 0] = S[1, 3] = S[3, 1] = s_ts
    Q = S * bg[None, :]
    np.fill_diagonal(Q, 0.0)
    np.fill_diagonal(Q, -Q.sum(axis=1))
    return Q / -(np.diag(Q) * bg).sum()


def _model(newick):
    bg = np.array([0.3, 0.2, 0.2, 0.3])
    from hal_tpu.tree import Tree

    tree = Tree.from_newick(newick)
    bl = {n: tree.branch_length(n) for n in tree.names()
          if tree.parent(n) is not None}
    m = NeutralModel(background=bg, rate_matrix=_gtr(bg), tree=tree,
                     branch_length=bl)
    m._decompose()
    return m


@pytest.fixture(scope="module")
def small():
    mod = _model("((A:0.1,B:0.2)AB:0.15,(C:0.3,D:0.1)CD:0.05)R;")
    leaves = ["A", "B", "C", "D"]
    leaf_idx = {n: i for i, n in enumerate(leaves)}
    rng = np.random.default_rng(3)
    pats = rng.integers(0, 5, (160, 4)).astype(np.int64)
    return mod, leaf_idx, pats


@pytest.mark.parametrize("mode", ["CONACC", "CON", "ACC", "NNEUT"])
def test_modes_match_numpy_f64(small, mode):
    from hal_tpu.phylop_jax import DevicePhyloP

    mod, leaf_idx, pats = small
    want = score_patterns(mod, leaf_idx, pats, mode)
    got = DevicePhyloP(mod, leaf_idx, mode).score_patterns(pats)
    # identical golden schedule + float64 everywhere (flat-likelihood
    # columns carry ~1e-8 optimizer noise through -log10)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_subtree_two_scale_fit(small):
    from hal_tpu.phylop_jax import DevicePhyloP

    mod, leaf_idx, pats = small
    sub = frozenset(["CD", "C", "D"])
    want = score_patterns(mod, leaf_idx, pats, "CONACC", sub_nodes=sub)
    got = DevicePhyloP(mod, leaf_idx, "CONACC", sub).score_patterns(pats)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_mammals_mod_f32_realistic(tmp_path):
    """A seeded 10-leaf .mod of mammal-like branch lengths: the device
    program against the float64 numpy oracle, within the 1e-6 score-unit
    tolerance the device fit states."""
    from hal_tpu.phylop_jax import DevicePhyloP

    p = tmp_path / "neutral.mod"
    p.write_text(random_mod_text(seed=1))
    mod = NeutralModel.from_mod_file(str(p))
    leaves = [n for n in mod.tree.names() if mod.tree.is_leaf(n)]
    leaf_idx = {n: i for i, n in enumerate(leaves)}
    rng = np.random.default_rng(0)
    pats = rng.integers(0, 5, (300, len(leaves))).astype(np.int64)
    want = score_patterns(mod, leaf_idx, pats, "CONACC")
    got = DevicePhyloP(mod, leaf_idx, "CONACC").score_patterns(pats)
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_scorer_device_dispatch(tmp_path):
    """PhyloPScorer(device='on') scores a real window identically to the
    numpy path (device='off')."""
    from fixtures import three_genome_alignment

    aln = three_genome_alignment()
    leaves = [n for n in aln.genome_names() if aln.tree.is_leaf(n)]
    newick = "(%s:0.2,%s:0.3)Anc;" % (leaves[0], leaves[1])
    mod = _model(newick)
    p = tmp_path / "m.mod"
    rows = "\n".join("  " + " ".join("%.10f" % v for v in r)
                     for r in mod.rate_matrix)
    p.write_text("ALPHABET: A C G T \nORDER: 0\nSUBST_MOD: REV\n"
                 "BACKGROUND: %s \nRATE_MAT:\n%s\nTREE: %s\n"
                 % (" ".join("%.6f" % b for b in mod.background), rows,
                    newick))
    g = aln.open_genome(leaves[0])
    n = min(64, int(g.length))
    off = PhyloPScorer(aln, NeutralModel.from_mod_file(str(p)),
                       device="off")
    on = PhyloPScorer(aln, NeutralModel.from_mod_file(str(p)),
                      device="on")
    s_off = off.score_window(leaves[0], 0, n)
    s_on = on.score_window(leaves[0], 0, n)
    assert on._dev is not None, "device path did not engage"
    np.testing.assert_allclose(s_on, s_off, atol=1e-6)


def test_products_run_in_float64(small):
    """The fit's products never run in reduced precision (TF32 on GPU
    tensor cores applies to float32 only): every dot_general of the
    traced fit takes and gives float64."""
    import jax
    import jax.numpy as jnp

    from hal_tpu.phylop_jax import DevicePhyloP

    mod, leaf_idx, _pats = small
    d = DevicePhyloP(mod, leaf_idx, "CONACC")
    codes = jnp.zeros((d.nleaf, 8), jnp.int32)
    jaxpr = jax.make_jaxpr(d._build_jit(8))(codes)
    dots = [e for e in _all_eqns(jaxpr.jaxpr)
            if e.primitive.name == "dot_general"]
    assert len(dots) >= 2 * 6 + 1  # two per edge (6 edges) + the root
    for e in dots:
        assert all(v.aval.dtype == jnp.float64 for v in e.invars + e.outvars)


def _all_eqns(jx):
    """Every equation of a jaxpr, nested ones (jit, loops) included."""
    for e in jx.eqns:
        yield e
        for p in e.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    yield from _all_eqns(inner)
