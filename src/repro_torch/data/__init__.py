"""Port of ``repro.data``: the seismic simulation and the window loader."""
