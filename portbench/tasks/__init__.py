"""One module a model family: ``build`` puts the program's networks, optimisers
and train step together from the benchmark's weights, ``REFERENCE`` names
the plain reference that follows its first steps, and ``reference_noise``
gives that reference the noise the program's steps draw (None where they draw
none)."""
