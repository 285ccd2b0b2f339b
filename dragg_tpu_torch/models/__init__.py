"""Home physics: RC thermal steps, battery, PV and the fallback controller."""
