from .mesh import make_mesh  # noqa: F401
