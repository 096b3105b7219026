"""The comparison that decides a run's `correct`, on the plain reference.

Each rANS stream that the card coded in a kept file is decoded by the
frozen `rans_np.decode` and compared with the other side of the call: for
an encode, the payload the program handed the card; for a decode, the bytes
the card gave back. A stream whose header does not give the expected
length, or that the reference cannot decode, counts as wrong.
"""

from . import rans_np


def stream_wrong(stream, want) -> bool:
    """Whether `stream` fails to decode to the bytes `want`."""
    stream = bytes(stream)
    if len(stream) < 6 or int.from_bytes(stream[2:6], "little") != len(want):
        return True
    try:
        return rans_np.decode(stream) != bytes(want)
    except Exception:       # any malformed stream is wrong, whatever it breaks
        return True


def streams_wrong(kind: str, kept: dict) -> tuple:
    """(streams checked, streams wrong) over the kept calls {slot: [(ins,
    outs)]} of `kind` ("encode": ins are payloads and outs streams;
    "decode": the reverse)."""
    checked = wrong = 0
    for calls in kept.values():
        for ins, outs in calls:
            if len(ins) != len(outs):
                checked += max(len(ins), len(outs))
                wrong += abs(len(ins) - len(outs))
            for a, b in zip(ins, outs):
                stream, want = (b, a) if kind == "encode" else (a, b)
                checked += 1
                wrong += stream_wrong(stream, want)
    return checked, wrong
