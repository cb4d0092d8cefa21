"""Jobs of the window that raised, exited non-zero, came back ``cached``
or, where the cell asks for it, launched no K2."""


def read(answers):
    return len(answers["failed"])
