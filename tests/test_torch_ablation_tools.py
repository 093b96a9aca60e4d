"""The ablation tools (``acf_tpu_torch/tools/k3b_ablation.py``,
``k3d_ablation.py``) make their variants by text substitution of
``csrc/apl_gen.cu``: each must find its form in the committed source and
change it, so a later edit of the kernels cannot silently time the
unchanged kernel under a variant's name."""

import pytest

from acf_tpu_torch.ops import _build
from acf_tpu_torch.tools import k3b_ablation, k3d_ablation

SOURCE = (_build.CSRC_DIR / "apl_gen.cu").read_text()
EXPECTED = {
    k3b_ablation: ("as_is", "no_store", "no_loads", "no_traffic", "no_math"),
    k3d_ablation: ("as_is", "no_loads", "no_math", "neither"),
}


@pytest.mark.parametrize("tool,name", [(tool, name) for tool, names in EXPECTED.items()
                                       for name in names],
                         ids=lambda v: getattr(v, "__name__", v).rsplit(".", 1)[-1])
def test_variant_applies_to_the_committed_source(tool, name):
    texts = tool.variants(SOURCE)
    assert sorted(texts) == sorted(EXPECTED[tool])
    assert (texts[name] == SOURCE) == (name == "as_is")
    # the variants differ from each other: none is a no-op copy of another
    assert len(set(texts.values())) == len(texts)


def test_k3d_forms_are_told_apart_by_their_markers():
    """The committed source has the staged form's marker and not the
    direct form's, so its variants are the staged ones."""
    (direct, _), (staged, _) = k3d_ablation.FORMS["direct"], k3d_ablation.FORMS["staged"]
    assert SOURCE.count(staged) == 1 and SOURCE.count(direct) == 0
    assert "stage_runs(sZ" not in k3d_ablation.variants(SOURCE)["neither"]
