"""MB staged host-to-device a decode dispatch over the window: the sum of
every session cache's ``TieredKVStats.bytes_staged`` (cold pages uploaded,
each once), read before each session's retirement closes its caches."""


def read(rec, name):
    n = rec.counters.get("decode_steps", 0)
    return rec.counters["bytes_staged"] / 1e6 / n if n else None
