"""Option-dict normalization shared by the option-taking wrappers."""


def opt_str(v) -> str:
    """Options are str->str like the reference; numbers stringify, bytes
    would silently become "b'..'" under str() and are decoded instead."""
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, (str, int, float)):
        return str(v)
    raise TypeError(f"option keys/values must be str/int/float, got "
                    f"{type(v).__name__}")
