"""The port's bag converter (`tools/torch_bag2islog.py`) against the JAX
package's (`tools/bag2islog.py`): the same synthetic in-memory rosbag 2.0
file (tests/test_bag2islog.py's bag writer; chunks uncompressed and bz2, a
message on another topic that both skip, a NaN point) goes
through both, and the two scan logs are equal byte for byte and read back
through the port's `ScanLog` as the frames that went in."""

import bz2
import struct
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

import bag2islog  # noqa: E402
import torch_bag2islog  # noqa: E402
from intensity_slam_tpu_torch.runtime import ScanLog  # noqa: E402
from test_bag2islog import H, N, TOPIC, W, _header, _pointcloud2, _record  # noqa: E402


def _make_bag(path, frames, compression: str) -> None:
    """tests/test_bag2islog.py:_make_bag, with the chunk compressed as
    asked, and a second connection (another topic) carrying one frame."""
    chunk = b""
    for conn, topic in ((3, TOPIC), (4, b"/other/points")):
        chunk += _record({b"op": b"\x07", b"conn": struct.pack("<I", conn), b"topic": topic},
                         _header({b"topic": topic, b"type": b"sensor_msgs/PointCloud2",
                                  b"md5sum": b"0" * 32, b"message_definition": b""})[4:])
    for k, (ts, xyz, inten) in enumerate(frames):
        conn = 4 if k == 1 else 3
        chunk += _record({b"op": b"\x02", b"conn": struct.pack("<I", conn),
                          b"time": struct.pack("<II", int(ts), 0)},
                         _pointcloud2(ts, xyz, inten))
    payload = bz2.compress(chunk) if compression == "bz2" else chunk
    bag = b"#ROSBAG V2.0\n"
    bag += _record({b"op": b"\x03", b"index_pos": struct.pack("<Q", 0),
                    b"conn_count": struct.pack("<I", 2),
                    b"chunk_count": struct.pack("<I", 1)}, b"")
    bag += _record({b"op": b"\x05", b"compression": compression.encode(),
                    b"size": struct.pack("<I", len(chunk))}, payload)
    path.write_bytes(bag)


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_both_converters_write_the_same_bytes(tmp_path, compression):
    rng = np.random.RandomState(7)
    frames = [(10.0 + 0.1 * k, rng.randn(N, 3).astype(np.float32),
               rng.rand(N).astype(np.float32)) for k in range(4)]
    frames[2][1][5] = np.nan                       # NaN points become zeros
    bag = tmp_path / "in.bag"
    _make_bag(bag, frames, compression)
    ref, port = tmp_path / "ref.islog", tmp_path / "port.islog"
    n_ref = bag2islog.convert(str(bag), str(ref), TOPIC.decode(), H, W)
    n_port = torch_bag2islog.convert(str(bag), str(port), TOPIC.decode(), H, W)
    assert n_ref == n_port == 3                    # frame 1 is on the other topic
    assert port.read_bytes() == ref.read_bytes()
    kept = [frames[k] for k in (0, 2, 3)]
    with ScanLog(str(port)) as log:
        assert (log.height, log.width, len(log)) == (H, W, 3)
        for k, (ts, xyz, inten) in enumerate(kept):
            assert abs(log[k].timestamp - ts) < 1e-6
            np.testing.assert_array_equal(log[k].xyz, np.nan_to_num(xyz))
            np.testing.assert_array_equal(log[k].intensity, inten)


def test_main_refuses_a_missing_card(tmp_path):
    """The default device is the card: without one the tool raises before
    it writes anything."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        torch_bag2islog.main([str(tmp_path / "in.bag"), str(tmp_path / "out.islog")])
    assert not (tmp_path / "out.islog").exists()
