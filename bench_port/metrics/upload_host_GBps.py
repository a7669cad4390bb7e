"""upload_host_GBps (GB/s): the program's counter ``clean_upload_bytes``
over its phase total ``clean_upload_s``: the bytes of the cube and weights
copied to the card over the host time of those copies, every call of the
process (the set-up call included).  Nothing to read where the program
keeps no such counter."""


def read(ctx):
    from iterative_cleaner_tpu_torch.obs import tracing

    snap = tracing.counters_snapshot()
    nbytes, seconds = snap.get("clean_upload_bytes"), snap.get("clean_upload_s")
    if not nbytes or not seconds:
        return None
    return nbytes / seconds / 1e9
