"""Output writers: the port's own copies of the JAX package's character sets,
IBM labels, interpreted text dump and peak statistics."""
