"""The control on the card: the plain reference computed with TF32 on (the
nearest precision below the configurations' float32) in the program's
place comes out not correct, at each cell's own size with the fewest
timed windows.  Run on the card:

    python -m pytest portbench/tests/test_pb_control.py -q
"""

import json
import time

import pytest

from pb_helpers import CELLS

SEEDS = (201, 202, 2147483201)


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(card, name, seed):
    from portbench.harness import cell as runner, report, spec
    c = spec.load(name)
    _, numbers = runner.run(c, seed, 1.0, False, time.perf_counter(),
                            device=card, control=True)
    checked = report.checks(c.spec["limits"], numbers)
    print("CONTROL", name, seed, json.dumps(dict(numbers)))
    assert not report.correct(checked), checked
