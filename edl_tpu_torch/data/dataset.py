"""File splitters: files to numbered records (a copy of the JAX package's
``data/dataset.py``), so the data service can checkpoint processed records
by number (``cluster/state.py:DataCheckpoint``)."""

from __future__ import annotations

from typing import Iterator


class FileSplitter:
    """Interface: iterate ``(record_no, record)`` over one file."""

    def split(self, path: str) -> Iterator[tuple[int, object]]:
        raise NotImplementedError


class TxtFileSplitter(FileSplitter):
    """One record per non-empty line."""

    def split(self, path: str) -> Iterator[tuple[int, str]]:
        record_no = 0
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if line:
                    yield record_no, line
                    record_no += 1


class RecordioSplitter(FileSplitter):
    """One record per CRC-checked recordio entry (``native/recordio.py``):
    the image format, so the data service feeds the ResNet workload."""

    def split(self, path: str) -> Iterator[tuple[int, bytes]]:
        from edl_tpu_torch.native.recordio import RecordReader
        reader = RecordReader(path)
        try:
            yield from enumerate(reader)
        finally:
            reader.close()
