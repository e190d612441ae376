"""The port's Config carries the reference's fields, defaults and YAML map."""

import dataclasses

from covins_tpu.utils.config import Config as RefConfig
from covins_tpu_torch.utils.config import Config


def test_fields_and_defaults_equal_reference():
    ref = {f.name: f.default for f in dataclasses.fields(RefConfig)}
    got = {f.name: f.default for f in dataclasses.fields(Config)}
    assert got == ref
    assert Config._YAML_MAP == RefConfig._YAML_MAP


def test_yaml_overrides_like_reference(tmp_path):
    path = tmp_path / "config_backend.yaml"
    path.write_text("%YAML:1.0\nplacerec.active: 0\nopt.wt_kf_R: 3.5\n"
                    "feat.type: 'ORB'  # comment\n")
    ref = RefConfig.from_yaml(str(path), vocab_words=64)
    got = Config.from_yaml(str(path), vocab_words=64)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.placerec_active is False and got.wt_kf_R == 3.5
