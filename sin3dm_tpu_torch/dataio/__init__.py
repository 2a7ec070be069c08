"""Host-side grid helpers."""
