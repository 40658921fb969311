"""Padded token slots over the token slots launched, in percent: for every
forward of the window its rows x seq bucket, against the tokens of its real
rows (the mask's count; a padded row holds one pad token). Job cells only."""


def read(run):
    if run.kind != "job" or not run.forwards:
        return None
    slots = sum(f["rows"] * f["seq"] for f in run.forwards)
    real = sum(f["real_tokens"] for f in run.forwards)
    return 100.0 * (1.0 - real / slots)
