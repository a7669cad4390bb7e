"""preprocess_s (s): the mean duration of the program's
``ops/preprocess.py: preprocess`` calls, from the Python tracer's events."""


def read(ctx):
    calls = ctx.trace.python_calls("ops/preprocess.py", "preprocess")
    if not calls:
        return None
    return sum(e.dur for e in calls) / len(calls)
