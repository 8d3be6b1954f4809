"""plan_ms (ms a round): host clock around the harness's
``RoundPlan.connectivity_aware`` calls over the window, over the rounds
those plans cover."""


def read(rec):
    if rec.plan_rounds <= 0:
        return None
    return rec.plan_s * 1e3 / rec.plan_rounds
