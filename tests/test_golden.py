"""Golden-artifact regression: today's pipeline must reproduce the checked-in
artifact tree of a tiny synthetic trial, in both quirk modes, through the
same loaders a reference consumer uses. This pins the interop
surface — file set, formats, and numerics — permanently, in an image that can
never run the reference's PyVista/MNE stack to cross-check."""

import pytest

from tests import golden_utils as G


@pytest.mark.parametrize("quirks", [False, True],
                         ids=["quirks_off", "quirks_on"])
def test_golden_artifacts_reproduced(tmp_path, quirks):
    golden = G.mode_dir(quirks)
    assert golden.exists(), (
        f"golden fixtures missing at {golden}; regenerate with "
        "`python -m tests.golden_utils`")
    fresh_root = tmp_path / "fresh"
    G.generate(fresh_root, quirks)
    got = G.artifact_files(fresh_root)
    want = G.artifact_files(golden)
    assert sorted(got) == sorted(want), (
        "artifact file set changed:\n"
        f"  extra:   {sorted(set(got) - set(want))}\n"
        f"  missing: {sorted(set(want) - set(got))}")
    for name in sorted(want):
        G.compare_artifact(name, got[name], want[name])


def test_golden_trees_have_same_file_set():
    """Both quirk-mode fixture trees expose the same artifact layout (the
    quirks change values on affected inputs, never the file set; quirk
    value differences are covered by the dedicated parity tests in
    test_ops_analysis / test_pipeline)."""
    off = G.artifact_files(G.mode_dir(False))
    on = G.artifact_files(G.mode_dir(True))
    assert sorted(off) == sorted(on)
    assert len(off) == 11
