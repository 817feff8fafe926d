"""The port's TensorBoard event files (``tdnet_torch/train/events.py``,
behind ``MetricsWriter(tensorboard_dir=...)``) against the file that the
reference's ``MetricsWriter`` wrote through tensorflow for the same
records (``tests/golden/tensorboard_scalars.tfevents``, made by
``tools/make_tb_golden.py``). Both are parsed with tensorboard's own
``event_pb2``; wall times differ."""

import glob
import os
import struct

import pytest

from tdnet_torch.train import events
from tdnet_torch.train.loop import MetricsWriter

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "tensorboard_scalars.tfevents")

# as the train loop writes them: step records, then epoch records (a
# bool, a string and an int among the values)
RECORDS = [
    {"epoch": 0, "step": 1, "loss": 1.8421, "classification_loss": 1.13,
     "regression_loss": 0.7121, "num_positive": 12, "lr": 1e-05, "grad_norm": 3.5e-4,
     "images_per_sec": 7.25},
    {"epoch": 0, "step": 2, "loss": 1.80001, "lr": 1e-05, "backbone": "resnet50"},
    {"epoch": 0, "epoch_loss": 1.8, "epoch_time_s": 12.5, "host_rss_mb": 2048.0,
     "mAP": 0.125, "weighted_mAP": 0.25},
    {"epoch": 1, "step": 3, "loss": -0.5, "lr": 1.0000000000000002e-06},
    {"epoch": 1, "epoch_loss": 20.0, "loss_spike": True, "mAP": 0.0},
]


def _parse(path):
    """[(step, tag, plugin name, dtype, float32 value)] and the file
    version, through tensorboard's protobufs."""
    from tensorboard.compat.proto import event_pb2

    with open(path, "rb") as f:
        data = f.read()
    out, versions, pos = [], [], 0
    while pos < len(data):
        n = struct.unpack_from("<Q", data, pos)[0]
        event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
        pos += 16 + n
        if event.file_version:
            versions.append(event.file_version)
        for v in event.summary.value:
            value = struct.unpack("<f", v.tensor.tensor_content)[0]
            out.append((event.step, v.tag, v.metadata.plugin_data.plugin_name,
                        v.tensor.dtype, list(v.tensor.tensor_shape.dim), value))
    return out, versions


def test_port_events_equal_reference(tmp_path):
    writer = MetricsWriter(str(tmp_path / "m.jsonl"), str(tmp_path / "tb"))
    for record in RECORDS:
        writer.write(record)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*.v2"))
    got, got_versions = _parse(path)
    want, want_versions = _parse(GOLDEN)
    assert got_versions == want_versions == ["brain.Event:2"]
    assert got == want
    assert len(got) == sum(1 for r in RECORDS for k, v in r.items()
                           if k != "step" and isinstance(v, (int, float)))


def test_reader_checks_every_crc(tmp_path):
    """The port's reader gives what event_pb2 gives, and refuses a file
    with one byte changed in a length or in a record's data."""
    parsed = events.read_events(GOLDEN)
    assert parsed[0]["file_version"] == "brain.Event:2"
    got = [(e["step"], v["tag"], v["plugin_name"], v["dtype"], [], v["value"])
           for e in parsed for v in e["values"]]
    assert got == _parse(GOLDEN)[0]
    data = bytearray(open(GOLDEN, "rb").read())
    first = struct.unpack_from("<Q", data, 0)[0]
    for at, what in ((1, "length CRC"), (12 + first + 16 + 20, "data CRC")):
        bad = bytearray(data)
        bad[at] ^= 0x40
        (tmp_path / "bad").write_bytes(bytes(bad))
        with pytest.raises(ValueError, match=what):
            events.read_events(str(tmp_path / "bad"))


def test_crc32c_check_values():
    assert events.crc32c(b"") == 0
    assert events.crc32c(b"123456789") == 0xE3069283
