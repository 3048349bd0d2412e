"""The correctness control on the card: the pipeline given its cameras'
focal lengths 2 % long (benchmark/control.py focal2) must come out not
correct in the dsec_esio.drive cell (its limits), at a window a test run
can hold.  Skips without a card."""
import json

import pytest

import run


@pytest.mark.card
def test_focal2_control_is_not_correct(card, capsys):
    args = ["--workload", "dsec_esio.drive", "--seed", "4294967311",
            "--seconds", "20", "--trace", "0"]
    assert run.main(args, control="focal2") == 0
    r = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r["correct"] is False
