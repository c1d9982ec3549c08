"""One file per backbone, named as the program's ``MODEL.BACKBONE``, whose
``Backbone`` is the plain model: a configuration with a new backbone adds a
file here."""
