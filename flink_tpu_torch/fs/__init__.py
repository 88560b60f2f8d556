"""Cloud filesystem drivers for the scheme-routed FileSystem SPI (C4)."""
