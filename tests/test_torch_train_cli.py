"""The port's training CLI refuses what it has not ported, naming its
ROADMAP item: checkpoint IO (queue 1 item 9), the other trainer families
(item 10) and the device mesh (item 11).  Each refusal comes before the
dataset or a model is built, so the test takes well under a second and
imports no JAX."""

import pytest

from unigeo_tpu_torch import train

CONFIG = dict(dataset="SyntheticBoxDataset", root=None, h=64, w=64, clip_length=2,
              clip_overlap=0, split="test", model_name="DepthCrafter",
              dataset_params=dict(render_size=[64, 64], num_scenes=1, frames_per_scene=2))


@pytest.mark.parametrize("extra,item", [
    (["--ckpt-dir", "ckpt"], "item 9"),
    (["--mesh", "1,1,1"], "item 11"),
    (["--model", "Cut3R"], "item 10"),
])
def test_train_cli_refuses_unported_options_naming_their_item(capsys, extra, item):
    with pytest.raises(SystemExit) as exc:
        train.main(["--device", "cpu", "--tiny", "--steps", "1", *extra], config=dict(CONFIG))
    said = f"{exc.value.code} {capsys.readouterr().err}"
    assert f"ROADMAP.md queue 1 {item}" in said, said
