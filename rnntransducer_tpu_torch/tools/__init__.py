"""Scripts that measure the port on the card; nothing on a path imports them."""
