"""setup.operands_s: the host clock around the program's
``FullGraphSource`` construction in set-up (normalisation, tiling,
upload), synchronised with the device."""


def read(out):
    return out["operands_s"]
