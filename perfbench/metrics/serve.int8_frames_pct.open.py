"""serve.int8_frames_pct.open: the share, in %, of the window's served
frames that the server computed on its int8 path (DepthServer.served,
read before and after the window)."""


def read(r):
    total = sum(r.served.values())
    return 100.0 * r.served.get("int8", 0) / total if total else None
