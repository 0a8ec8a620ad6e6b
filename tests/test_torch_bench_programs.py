"""The port's stage profilers (``eppm_tpu_torch/bench``) on the CPU:
each exits non-zero without a card unless ``--device cpu`` is given."""

import importlib

import pytest
import torch


# The suite runs several test processes per host: one torch thread each
# keeps them from oversubscribing the cores.
torch.set_num_threads(1)

PROGRAMS = ["profile_stages", "profile_match"]


def program(name):
    return importlib.import_module(f"eppm_tpu_torch.bench.{name}")


@pytest.mark.parametrize("name", PROGRAMS)
def test_no_card_exits_nonzero(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        program(name).main([])
    assert e.value.code not in (0, None)
    assert "no CUDA device" in str(e.value.code)
    assert capsys.readouterr().out == ""
