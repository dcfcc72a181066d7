"""The database's bytes on the card, GB: DeviceDB.table_bytes, or out of
core the chunk slots' planes."""


def read(ctx):
    c = ctx["classifier"]
    if c.device.type != "cuda":
        return None
    if c._ooc is None:
        return sum(db.table_bytes for db in c.dbs) / 1e9
    slots = c._ooc_slots._planes
    return sum(p.numel() * p.element_size() for s in slots for p in s) / 1e9 if slots else None
