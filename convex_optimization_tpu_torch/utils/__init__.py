"""Host helpers: device policy and the native runtime binding."""
