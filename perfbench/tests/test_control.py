"""The control: the reference in the program's place, its transform passes
in TensorFloat-32, its files judged by the harness's own comparison, comes
out as not correct at a size a test run holds. float32 with TF32 off gives
the same bits as the exact reference, and its files come out correct."""

import dataclasses
import json

from perfbench import content, control, correct
from perfbench.reference import container, judge

CONFIG = json.loads((control.ROOT / "perfbench" / "configs" / "kodak768_q60_s6.json").read_text())
SMALL = dict(CONFIG, width=256, height=192)


def test_tf32_control_fails_and_float32_does_not():
    low = control.readings(SMALL, 2**31 + 21, 2, "tf32", "cpu")
    assert not low["correct"] and low["checks"]["wrong_files"] >= 1, low
    assert sum(low["luma_blocks_differing"]) >= 1, low
    same = control.readings(SMALL, 2**31 + 21, 2, "float32", "cpu")
    assert same["correct"] and same["checks"]["wrong_files"] == 0, same


def test_reference_writer_files_pass_the_judge_and_a_changed_payload_does_not():
    pool = content.frames(1, 96, 64, 2**31 + 5, "cpu")
    cfg = dict(CONFIG, width=96, height=64)
    want = correct.expected(cfg, pool, "cpu")[0]
    judge.check(container.still(want), want)
    payload = want.frame_payload[:-1] + bytes([want.frame_payload[-1] ^ 1])
    try:
        judge.check(container.still(dataclasses.replace(want, frame_payload=payload)), want)
    except judge.Bad:
        return
    raise AssertionError("a changed payload passed the judge")

