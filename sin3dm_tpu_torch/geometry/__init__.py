"""Host geometry of the mesh path: the C++ library and its callers."""
