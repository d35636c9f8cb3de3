"""The device mesh (``mesh.py``) and the search collectives over it
(``collectives.py``)."""
