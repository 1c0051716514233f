"""Host-side helpers: the native setup runtime binding."""
