"""codec_mib_s: MiB encoded plus MiB decoded over the whole window, whose
end waits for the card.  Host clock."""


def read(run):
    w = run.window
    return w["bytes"] / (1 << 20) / w["seconds"]
