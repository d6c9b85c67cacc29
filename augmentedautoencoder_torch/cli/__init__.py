"""Command-line helpers of the port (copy of augmentedautoencoder_tpu/cli/__init__.py)."""


def split_experiment_name(full: str):
    """'group/name' -> (name, group); bare 'name' -> (name, '')."""
    parts = full.split("/")
    name = parts.pop()
    group = parts.pop() if parts else ""
    return name, group
