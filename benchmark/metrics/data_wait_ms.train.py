"""Host ms a step spends in ``next()`` on the ``DevicePrefetcher``, from the
benchmark's wrapper around the iterator the Solver reads."""


def read(st):
    steps = st.units.get("steps", 0)
    return st.units["data_wait_s"] * 1e3 / steps if steps else None
