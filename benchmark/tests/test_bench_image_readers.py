"""The image front end's device readers on a hand-built traced slice: two
`frontend_image` ranges, each closed by a card synchronisation, device
intervals inside, across and outside them, and host-to-card copies."""
import pytest

from harness import cell
from harness.trace import Slice

SYNC = "cudaDeviceSynchronize"


def _slice(device_iv, ticks=2):
    # times in us: range 1 is [100, 200] closed by the sync ending at 230,
    # range 2 is [500, 600] closed by the sync ending at 640
    host = [("frontend_event", 0, 90, None), (SYNC, 90, 95, None),
            ("frontend_image", 100, 200, None), (SYNC, 200, 230, None),
            ("estimator", 240, 480, None), (SYNC, 480, 490, None),
            ("frontend_image", 500, 600, None), (SYNC, 600, 640, None)]
    return Slice({}, ticks, 1e-3, device_iv, host, [], None)


IV = [
    ("lk_track_kernel", 20, 80),                          # event front end
    ("Memcpy HtoD (Pageable -> Device)", 110, 150),       # frame upload
    ("void pyr_down_kernel", 140, 190),                   # overlaps it
    ("void shi_tomasi_kernel", 210, 260),                 # to the sync: 20
    ("sm80_xmma_gemm", 300, 400),                         # estimator
    ("Memcpy HtoD (Pageable -> Device)", 420, 430),       # estimator's copy
    ("void cat_kernel", 490, 520),                        # from 500: 20
    ("Memcpy HtoD (Pageable -> Device)", 530, 540),       # second upload
    ("Memcpy DtoH (Device -> Pageable)", 620, 700),       # to 640: 20
]


def test_device_time_inside_the_image_ranges():
    r = cell.reader("frontend_image_device_ms")
    # range 1: [110, 190] and [210, 230]; range 2: [500, 520], [530, 540],
    # [620, 640]: 150 us over two ticks
    assert r.read(_slice(IV)) == pytest.approx(150e-3 / 2)


def test_host_to_card_copies_inside_the_image_ranges():
    r = cell.reader("frame_upload_ms")
    # the two uploads inside the ranges (40 + 10 us), not the estimator's
    assert r.read(_slice(IV)) == pytest.approx(50e-3 / 2)


@pytest.mark.parametrize("name", ["frontend_image_device_ms",
                                  "frame_upload_ms"])
def test_nothing_to_read_reads_none(name):
    r = cell.reader(name)
    no_image = Slice({}, 2, 1e-3, IV, [("estimator", 0, 700, None)], [], None)
    assert r.read(no_image) is None
    assert r.read(_slice([])) is None     # a CPU run: no device interval
    assert r.read(_slice(IV, ticks=0)) is None
