"""The ablation tools (``acf_tpu_torch/tools/k3a_ablation.py``,
``k3b_ablation.py``, ``k3c_ablation.py``, ``k3d_ablation.py``,
``k3e_ablation.py``, ``k2b_ablation.py``, ``k2a_ablation.py``,
``k1_ablation.py``) make their variants by text substitution of
``csrc/apl_gen.cu`` (K2b's: of ``sasrec_encoder_bwd.cu`` with its header and
K2a's file; K2a's: of ``sasrec_encoder_fwd.cu`` with its header; K1's: of
``rank_count.cu`` with its header): each must find its form in the
committed source and change it, so a later edit of the kernels cannot
silently time the unchanged kernel under a variant's name."""

import pytest

from acf_tpu_torch.ops import _build
from acf_tpu_torch.tools import (ablation, k1_ablation, k2a_ablation, k2b_ablation,
                                 k2b_wide_ablation, k3a_ablation, k3b_ablation, k3c_ablation,
                                 k3d_ablation, k3e_ablation)

SOURCE = (_build.CSRC_DIR / "apl_gen.cu").read_text()
K2B_SOURCE = k2b_ablation.read(str(_build.CSRC_DIR / "sasrec_encoder_bwd.cu"))
K2A_SOURCE = k2a_ablation.read(str(_build.CSRC_DIR / "sasrec_encoder_fwd.cu"))
K2B_WIDE_SOURCE = ablation.read_source(_build.CSRC_DIR / "sasrec_encoder_bwd.cu")
K1_SOURCE = ablation.read_source(_build.CSRC_DIR / "rank_count.cu")
EXPECTED = {
    k3a_ablation: ("as_is", "no_merge", "no_math", "neither"),
    k3b_ablation: ("as_is", "no_store", "no_loads", "no_traffic", "no_math"),
    k3c_ablation: ("as_is", "no_loads", "no_math", "neither"),
    k3d_ablation: ("as_is", "no_loads", "no_math", "neither"),
    k3e_ablation: ("as_is", "no_loads", "no_math", "neither", "no_grads"),
    k2b_ablation: ("as_is", "no_wload", "no_attn_bwd", "no_remat", "no_reduce", "ldg_weights",
                   "three_products", "late_partial"),
    k2b_wide_ablation: ("as_is", "no_wload", "no_attn", "no_dsmem", "warps8", "stamps"),
    k2a_ablation: ("as_is", "no_wload", "no_attn", "no_ln", "no_saved", "ldg_weights",
                   "regs80", "no_pv", "keys7"),
    k1_ablation: ("as_is", "narrow_only", "wide_only", "tile4x4", "items64", "slice16",
                  "stages3", "bias_ldg", "split_grid", "users_resident", "unroll2", "no_copies",
                  "no_bload", "no_epilogue"),
}


def source_of(tool):
    return {k2b_ablation: K2B_SOURCE, k2b_wide_ablation: K2B_WIDE_SOURCE,
            k2a_ablation: K2A_SOURCE, k1_ablation: K1_SOURCE}.get(tool, SOURCE)


@pytest.mark.parametrize("tool,name", [(tool, name) for tool, names in EXPECTED.items()
                                       for name in names],
                         ids=lambda v: getattr(v, "__name__", v).rsplit(".", 1)[-1])
def test_variant_applies_to_the_committed_source(tool, name):
    source = source_of(tool)
    texts = tool.variants(source)
    assert sorted(texts) == sorted(EXPECTED[tool])
    assert (texts[name] == source) == (name == "as_is")
    # the variants differ from each other: none is a no-op copy of another
    assert len(set(texts.values())) == len(texts)


def committed_form(tool):
    """(marker, variants) of the form of ``tool``'s kernel that the committed
    source holds: the redesign of each kernel (K3a's ``own_loop``, the other
    tools' ``staged``)."""
    forms = [form for form in tool.FORMS.values() if source_of(tool).count(form[0]) == 1]
    assert len(forms) == 1, [form[0] for form in forms]
    return forms[0]


@pytest.mark.parametrize("tool", list(EXPECTED),
                         ids=lambda v: v.__name__.rsplit(".", 1)[-1])
def test_an_unknown_or_broken_form_is_refused(tool):
    """A source that holds no form's marker, or holds one but has lost an
    anchor of that form, stops the tool rather than timing the wrong text."""
    with pytest.raises(SystemExit, match="no known form"):
        tool.variants("")
    marker, staged = committed_form(tool)
    old = next(old for subs in staged.values() for old, _ in subs if marker not in old)
    with pytest.raises(SystemExit, match="does not match exactly once"):
        tool.variants(source_of(tool).replace(old, old + old))


@pytest.mark.parametrize("tool", list(EXPECTED),
                         ids=lambda v: v.__name__.rsplit(".", 1)[-1])
def test_staged_anchors_match_the_committed_source_once(tool):
    """Each tool's marker and every anchor of its committed form occur
    exactly once in the committed source: the kernels name their staged tiles
    apart (K3a ``sUa``/``sQa``, K3b ``sN``/``cn``, K3c ``sZc``/``cz``, K3d
    ``sZ``/``sM``, K3e ``sZe``/``sMe``), so no tool's anchor also matches
    another kernel."""
    marker, staged = committed_form(tool)
    assert source_of(tool).count(marker) == 1
    for subs in staged.values():
        for old, _ in subs:
            assert source_of(tool).count(old) == 1, old


def test_k3b_forms_are_told_apart_by_their_markers():
    (direct, _), (staged, _) = k3b_ablation.FORMS["direct"], k3b_ablation.FORMS["staged"]
    assert SOURCE.count(staged) == 1 and SOURCE.count(direct) == 0


def test_k3d_forms_are_told_apart_by_their_markers():
    """The committed source has the staged form's marker and not the
    direct form's, so its variants are the staged ones."""
    (direct, _), (staged, _) = k3d_ablation.FORMS["direct"], k3d_ablation.FORMS["staged"]
    assert SOURCE.count(staged) == 1 and SOURCE.count(direct) == 0
    assert "stage_runs(sZ," not in k3d_ablation.variants(SOURCE)["neither"]


def test_k3e_forms_are_told_apart_by_their_markers():
    """The committed source has the staged form's marker and not the
    direct form's; K3e's staging and reads have names of their own, so
    K3d's staged anchors still match only K3d's lines."""
    (direct, _), (staged, _) = k3e_ablation.FORMS["direct"], k3e_ablation.FORMS["staged"]
    assert SOURCE.count(staged) == 1 and SOURCE.count(direct) == 0
    texts = k3e_ablation.variants(SOURCE)
    assert "stage_runs(sZe" not in texts["neither"]
    assert "grad_dq<kC>(" in texts["as_is"] and "grad_dq<kC>(" not in texts["no_grads"]
    # K3d's variants take out K3d's staging and leave K3e's alone
    k3d_neither = k3d_ablation.variants(SOURCE)["neither"]
    assert "stage_runs(sZ," not in k3d_neither and "stage_runs(sZe," in k3d_neither



def test_k3c_forms_are_told_apart_by_their_markers():
    """The committed source has the staged form's marker and not the direct
    form's (the earlier kernel read z from device memory in ``chunk_loop``'s
    body); K3c stages z under names of its own, so K3b's z store and K3d's
    staging stay single and K3c's variants take out only K3c's staging."""
    (direct, _), (staged, _) = k3c_ablation.FORMS["direct"], k3c_ablation.FORMS["staged"]
    assert SOURCE.count(staged) == 1 and SOURCE.count(direct) == 0
    k3c = SOURCE[SOURCE.index("fake_kernel("):SOURCE.index("// ---- K3d")]
    assert "chunk_loop(" not in k3c and "stage_runs(sZc" in k3c and "/ rl2[i]" not in k3c
    texts = k3c_ablation.variants(SOURCE)
    assert "stage_runs(sZc" not in texts["neither"] and "stage_runs(sZ," in texts["neither"]
    assert "expf(" not in texts["no_math"][texts["no_math"].index("fake_kernel("):
                                           texts["no_math"].index("// ---- K3d")]
    assert SOURCE.count("z[(size_t)row * g.I + item] = v[j];") == 1  # K3b's store only


def test_k3a_forms_are_told_apart_by_their_markers():
    """The committed source has the redesign's marker and not the earlier
    kernel's (``chunk_loop``, commit 69f9b76, gone with it); ``no_merge`` drops K3a's merge
    and keeps K3b's, ``no_math`` leaves K3a no absorb and K3b its own."""
    (chunk, _), (own, _) = k3a_ablation.FORMS["chunk"], k3a_ablation.FORMS["own_loop"]
    assert SOURCE.count(own) == 1 and SOURCE.count(chunk) == 0
    assert "chunk_loop" not in SOURCE
    texts = k3a_ablation.variants(SOURCE)
    k3a = lambda text: text[text.index("stats1_kernel("):text.index("// ---- K3b")]
    assert "stat_absorb" in k3a(texts["as_is"]) and "stat_absorb" not in k3a(texts["no_math"])
    assert "stat_absorb<true>(m[i], l[i], v, live);" in texts["no_math"]  # K3b's
    for name in ("no_merge", "neither"):
        assert "combine_stats(part, m1, l1" not in texts[name]
        assert "combine_stats(part, m2, l2" in texts[name]  # K3b's merge stays


def test_k2b_forms_are_told_apart_by_their_markers():
    """The committed K2b text (header, backward, K2a's forward) holds the
    staged form's marker and not commit 202a5d5's, every variant keeps the
    marker (so its launch layout is found), and each variant takes out what
    it names: the weights' copies and reads, the attention backward's
    calls, the rematerialised forward, the reduction's launch. K2a's code,
    in the same text, is untouched by every variant."""
    (remat, _), (staged, _) = k2b_ablation.FORMS["remat"], k2b_ablation.FORMS["staged"]
    assert K2B_SOURCE.count(staged) == 1 and K2B_SOURCE.count(remat) == 0
    texts = k2b_ablation.variants(K2B_SOURCE)
    assert {k2b_ablation.form_of(text) for text in texts.values()} == {"staged"}
    assert "cp_async16(dst" not in texts["no_wload"]
    assert "attn_bwd_dqk(P" not in texts["no_attn_bwd"]
    assert "attention_fwd(X2" not in texts["no_remat"]
    assert "sasrec_encoder_bwd_reduce<<<" not in texts["no_reduce"]
    assert "ldg4(W[p]" in texts["ldg_weights"] and "cp_async16(dst" not in texts["ldg_weights"]
    assert "dense<true, 3>" not in texts["three_products"]
    assert "first || !inside(i, j) ? 0.f : wp[p]" not in texts["late_partial"]
    fwd = K2B_SOURCE[K2B_SOURCE.index("sasrec_encoder_fwd_kernel("):]
    assert all(text.endswith(fwd) for text in texts.values())


def test_k2b_wide_forms_are_told_apart_by_their_markers():
    """The committed K2b text holds the cluster form's marker and not the
    workspace form's (commits ff82a88 to f5941ac), every variant keeps the
    marker, and each variant takes out what it names: the weights' copies
    and reads, every attention step, every read of another CTA's shared
    memory; ``warps8`` runs the cluster kernel at 256 threads with three-row
    tiles; ``stamps`` defines the phase stamps the kernel names. The tile
    form's kernel is the same text in every variant but ``no_wload`` (whose
    weight reads the two forms share)."""
    (workspace, _), (cluster, _) = (k2b_wide_ablation.FORMS["workspace"],
                                    k2b_wide_ablation.FORMS["cluster"])
    assert K2B_WIDE_SOURCE.count(cluster) == 1 and K2B_WIDE_SOURCE.count(workspace) == 0
    texts = k2b_wide_ablation.variants(K2B_WIDE_SOURCE)
    assert {k2b_wide_ablation.form_of(text) for text in texts.values()} == {"cluster"}
    assert "cp_async_n<4>(dst" not in texts["no_wload"]
    body = texts["no_attn"][texts["no_attn"].index("sasrec_encoder_bwd_kernel_cluster("):]
    for step in ("cl_softmax(", "cl_rows(", "cl_partials(", "cl_ds(P", "gather(F", "cl_combine(F"):
        assert step in texts["as_is"] and step not in body
    body = texts["no_dsmem"][texts["no_dsmem"].index("sasrec_encoder_bwd_kernel_cluster("):]
    assert "gather(F" not in body and "cl_combine(F" not in body and "cl_ds(P" in body
    assert "constexpr int kWideThreads = kBf16 ? 384 : 256;" in texts["warps8"]
    assert "constexpr int kWideRowsPerThread = 3;" in texts["warps8"]
    assert "#define ACF_STAMP(k) acf_stamp(k)" in texts["stamps"]
    assert K2B_WIDE_SOURCE.count("ACF_STAMP(") == 26  # its empty define and 25 stamps
    tile = K2B_WIDE_SOURCE[K2B_WIDE_SOURCE.index("sasrec_encoder_bwd_kernel(const EncoderW"):
                           K2B_WIDE_SOURCE.index("// ---- the wide form")]
    assert all(tile in text for name, text in texts.items() if name != "no_wload")


def test_k2b_layouts_of_both_forms():
    """The remat form's layout is the one its C entry checked (ten buffers,
    152,360 bytes at T=50, 92,544 at T=8); the staged form's is the
    committed ``_bwd_layout``."""
    from acf_tpu_torch.ops.sasrec_fused import _bwd_layout

    assert k2b_ablation.LAYOUTS["remat"](50, 64) == (1, 256, 152_360)
    assert k2b_ablation.LAYOUTS["remat"](8, 64) == (4, 256, 92_544)
    for t in (1, 8, 50, 74):
        assert k2b_ablation.LAYOUTS["staged"](t, 64) == _bwd_layout(t, 64)


def test_k2a_forms_are_told_apart_by_their_markers():
    """The committed K2a text (the forward with its header inlined) holds the
    staged form's marker and not commit 6a7587e's, every variant keeps the
    marker (so its launch layout is found), and each variant takes out what
    it names: the weights' copies and reads, the attention's call, the
    LayerNorms' moments, both copies to ``saved``, the attention's sum over
    v, its score registers, the 256-thread kernel's registers. K2b's text holds the same form of K2a, so
    its tool launches K2a in that form's layout."""
    (ldg, _), (staged, _) = k2a_ablation.FORMS["ldg"], k2a_ablation.FORMS["staged"]
    assert K2A_SOURCE.count(staged) == 1 and K2A_SOURCE.count(ldg) == 0
    texts = k2a_ablation.variants(K2A_SOURCE)
    assert {k2a_ablation.form_of(text) for text in texts.values()} == {"staged"}
    assert "cp_async16(dst" not in texts["no_wload"]
    assert "attention_rows<2>(Q" not in texts["no_attn"]
    assert "half_sum(s) / d" not in texts["no_ln"]
    assert "saved == nullptr ? nullptr : saved" not in texts["no_saved"]
    assert "ldg4(W[p]" in texts["ldg_weights"] and "cp_async16(dst" not in texts["ldg_weights"]
    assert "c0 <= i; c0 += chunk" not in texts["no_pv"]
    assert "if (T <= 64)" not in texts["keys7"]
    assert "fwd_blocks_an_sm(THREADS))" not in texts["regs80"]
    assert k2a_ablation.form_of(K2B_SOURCE) == "staged"


def test_k2a_layouts_of_both_forms():
    """The ldg form's layout is the one its C entry checked (four buffers, a
    score row a warp, the ids mask as floats: 56,264 bytes at T=50, 35,200
    at T=8); the staged form's is the committed ``_layout``, in its own
    geometry or another one given."""
    from acf_tpu_torch.ops.sasrec_fused import _fwd_bytes, _fwd_slice, _layout

    assert k2a_ablation.LAYOUTS["ldg"](50, 64) == (1, 256, 56_264)
    assert k2a_ablation.LAYOUTS["ldg"](8, 64) == (4, 256, 35_200)
    for t in (1, 8, 50, 200):
        assert k2a_ablation.LAYOUTS["staged"](t, 64) == _layout(t, 64)
    for t, layouts in k2a_ablation.OTHER_LAYOUTS.items():
        for users, threads, ks in layouts.values():
            rows = users * t
            assert k2a_ablation.LAYOUTS["staged"](t, 64, users, threads, ks) == (
                users, threads, _fwd_bytes(rows, 64, ks or _fwd_slice(rows, 64, threads)))


def test_sources_build_alone_with_their_headers_inlined():
    """``read_source`` puts each header a source includes in place of its
    ``#include``, once, so a variant compiles alone in the build directory:
    every kernel source's text holds no local include and one copy of the
    shared cp.async helpers."""
    header = (_build.CSRC_DIR / "cp_async.cuh").read_text()
    for text in (K1_SOURCE, K2A_SOURCE, K2B_SOURCE,
                 ablation.read_source(_build.CSRC_DIR / "apl_gen.cu")):
        assert '#include "' not in text
        assert text.count(header) == 1
    for name in ("rank_count.cu", "apl_gen.cu", "sasrec_encoder.cuh"):
        text = (_build.CSRC_DIR / name).read_text()
        assert "cp.async.cg.shared.global" not in text and "int row_ld(" not in text


def test_k1_forms_and_variants():
    """The committed K1 holds the flat form's marker and not the split
    form's (commit 950a8bf, which has no variants); the slot variants change
    one "ablation" constant only, and each other variant swaps the code it
    names."""
    (split, none), (flat, _) = k1_ablation.FORMS["split"], k1_ablation.FORMS["flat"]
    assert K1_SOURCE.count(flat) == 1 and K1_SOURCE.count(split) == 0 and none == {}
    texts = k1_ablation.variants(K1_SOURCE)
    for name in ("slice16", "stages3"):
        changed = [line for line in texts[name].splitlines()
                   if line not in K1_SOURCE.splitlines()]
        assert len(changed) == 1 and "// ablation:" in changed[0], (name, changed)
    for name in ("narrow_only", "tile4x4", "items64"):
        assert "false ? launch<Wide>" in texts[name]
    assert "true ? launch<Wide>" in texts["wide_only"]
    assert "Shape<4, 2>" in texts["items64"] and "kRU = 4;" in texts["tile4x4"]
    assert "__ldg(a.bias + item)" in texts["bias_ldg"] and "__ldg" not in K1_SOURCE
    assert "gridDim.x / (a.n_units / a.n_item_tiles)" in texts["split_grid"]
    resident = texts["users_resident"]
    assert "resident = ut;" in resident and "&tm_u, ks * kSliceK, u0" not in resident
    assert "#pragma unroll 2" in texts["unroll2"]
    assert "tma_box(" not in texts["no_copies"].split("__global__")[0].split("stage(")[-1]
    assert set(k1_ablation.CHANGE_COUNTS) < set(texts) and set(k1_ablation.MAX_D) < set(texts)


def test_k1_shapes_cover_the_unit_edges():
    """``K1_SHAPES`` (checked by ``chip_smoke.py`` and the tool) holds one user,
    user counts either side of 128-user units, item counts either side of
    128-item units and of the ml-1m table, and widths from 4 past 256."""
    bs, items, ds = (set(x) for x in zip(*k1_ablation.K1_SHAPES))
    assert {1, 127, 129, 512, 513} <= bs
    assert {2, 129, 3_707, 23_700, 40_000} <= items
    assert {4, 36, 64, 128, 256, 260} <= ds and all(d % 4 == 0 for d in ds)
