"""Regenerate tests/golden/tensorboard_scalars.tfevents: the event file
that the reference's MetricsWriter (tdnet/train/loop.py, through
tensorflow's tf.summary) writes for tests/test_torch_events.py's RECORDS.
The port's writer is held against it without importing tensorflow in the
test run (~15 s).

Run from the repo root:  python tools/make_tb_golden.py
"""

import glob
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tdnet.train.loop import MetricsWriter  # noqa: E402
from tests.test_torch_events import GOLDEN, RECORDS  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as logdir:
        writer = MetricsWriter(None, logdir)
        for record in RECORDS:
            writer.write(record)
        writer.close()
        (path,) = glob.glob(os.path.join(logdir, "events.out.tfevents.*"))
        shutil.copyfile(path, GOLDEN)
    print(f"wrote {GOLDEN} ({os.path.getsize(GOLDEN)} bytes)")


if __name__ == "__main__":
    main()
