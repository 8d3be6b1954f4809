"""round_ms (ms): the window's host-clock time over all rounds completed
in it.  A round runs from the previous round's stamp to its own (each
stamp follows the evaluation hook's device synchronise), so a block's
plan, batch drawing and staging, and the evaluations, are all counted."""


def read(rec):
    if not rec.round_ms:
        return None
    return rec.window_s * 1e3 / rec.rounds
