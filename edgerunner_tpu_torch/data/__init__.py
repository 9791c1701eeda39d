from .mesh_io import clean_mesh, load_mesh, normalize_mesh, save_mesh_file
from .tokenize import detokenize_mesh, save_mesh, tokenize_mesh

__all__ = ["load_mesh", "clean_mesh", "normalize_mesh", "save_mesh_file",
           "detokenize_mesh", "save_mesh", "tokenize_mesh"]
