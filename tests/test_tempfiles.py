"""Temp-file registry (reference: src/tempfile.cpp exit-time wipe)."""
import os

from smoothxg_jax.utils import tempfiles


def test_create_register_cleanup(tmp_path):
    tempfiles.set_dir(str(tmp_path))
    p1 = tempfiles.create("unit")
    assert os.path.exists(p1)
    extra = tmp_path / "extra.bin"
    extra.write_bytes(b"x")
    tempfiles.register(str(extra))
    kept = tmp_path / "kept.bin"
    kept.write_bytes(b"y")
    tempfiles.register(str(kept))
    tempfiles.unregister(str(kept))
    tempfiles.cleanup()
    assert not os.path.exists(p1)
    assert not extra.exists()
    assert kept.exists()
    # registry is reusable after cleanup
    p2 = tempfiles.create("unit")
    assert os.path.exists(p2)
    tempfiles.cleanup()
    assert not os.path.exists(p2)
