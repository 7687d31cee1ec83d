"""The tile loader's ms a stack: the host clock around each read of the
next stack of tiles from the mosaic file (data.MosaicTiles.batches),
every call of the window."""


def read(run):
    return sum(run.read_ms) / len(run.read_ms) if run.read_ms else None
