"""One reference worker: ``python -m portbench.refworker JOB.json``.

Judges the text of ``JOB["text"]`` (lines joined, starts beside it) with
``JOB["patterns"]`` and writes the per-line hits to ``JOB["out"]``.
"""

import json
import os
import sys

import numpy as np

from portbench.reference import compile_rules, judge


def main(job_path: str) -> None:
    with open(job_path) as f:
        job = json.load(f)
    with open(job["text"], "rb") as f:
        text = f.read()
    starts = np.load(os.path.join(job["dir"], "starts.npy"))
    hit = judge(compile_rules(job["patterns"], job["ignore_case"]), text,
                starts)
    np.save(os.path.join(job["dir"], job["out"]), hit)


if __name__ == "__main__":
    main(sys.argv[1])
