"""The general drivers that traffic mixes name (``"driver"`` in a mix's file)."""
