from ..s3d import S3D as Backbone  # noqa: F401
