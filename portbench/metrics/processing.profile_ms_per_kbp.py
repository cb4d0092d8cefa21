"""The program's activity profile stages (`profile` and `smooth_extract`),
summed over the pool's workers, ms a kbp called."""


def read(record):
    st = record["stages"]
    if "profile" not in st or not record["kbp"]:
        return None
    ms = (st["profile"] + st.get("smooth_extract", 0.0)) * 1e3
    return ms / record["kbp"]
