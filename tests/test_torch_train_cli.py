"""The port's training CLI refuses a malformed option, naming it: a
``--mesh`` that is not three positive integers dp,sp,tp (the mesh itself
runs since the training side of ``parallel/`` was ported; the test once
pinned its refusal).  The refusal comes before the dataset or a model is
built, so the test takes well under a second and imports no JAX."""

import xdist_threads  # noqa: F401  (torch's CPU threads shared among xdist workers)

import pytest

from unigeo_tpu_torch import train

CONFIG = dict(dataset="SyntheticBoxDataset", root=None, h=64, w=64, clip_length=2,
              clip_overlap=0, split="test", model_name="DepthCrafter",
              dataset_params=dict(render_size=[64, 64], num_scenes=1, frames_per_scene=2))


@pytest.mark.parametrize("extra,item", [
    (["--mesh", "1,1"], "--mesh '1,1': expected dp,sp,tp"),
])
def test_train_cli_refuses_unported_options_naming_their_item(capsys, extra, item):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--tiny", "--steps", "1", *extra], config=dict(CONFIG))
    said = f"{exc.value.code} {capsys.readouterr().err}"
    assert item in said, said
