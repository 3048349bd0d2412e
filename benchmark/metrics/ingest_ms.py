"""ingestion: the harness's own host-clock span around each pull from the
port's chunker (io/datasets.iterate_chunks_fast through the native
packetizer, the host-to-card copy of both cameras' chunks, and the
pairing), the mean over every tick of the window (ms per tick)."""

LAYER = "ingestion"
UNIT = "ms"


def read(s):
    if not s.ingest_s:
        return None
    return sum(s.ingest_s) / len(s.ingest_s) * 1e3
