"""Analytics examples of the port: the analytics hooks over a data loader."""
