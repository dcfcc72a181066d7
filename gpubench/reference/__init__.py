"""The plain NumPy reference that decides whether a run is correct."""
