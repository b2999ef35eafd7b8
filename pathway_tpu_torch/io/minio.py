"""MinIO connector (reference ``python/pathway/io/minio``): S3-compatible —
the S3 connector with endpoint-style settings."""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.io import s3 as _s3
from pathway_tpu_torch.io.s3 import AwsS3Settings


class MinIOSettings:
    def __init__(
        self,
        endpoint: str | None = None,
        bucket_name: str | None = None,
        access_key: str | None = None,
        secret_access_key: str | None = None,
        with_path_style: bool = True,
        *,
        client: Any = None,
    ):
        self.endpoint = endpoint
        self.bucket_name = bucket_name
        self.access_key = access_key
        self.secret_access_key = secret_access_key
        self.with_path_style = with_path_style
        self.client = client

    def create_aws_settings(self) -> AwsS3Settings:
        return AwsS3Settings(
            bucket_name=self.bucket_name,
            access_key=self.access_key,
            secret_access_key=self.secret_access_key,
            endpoint=self.endpoint,
            with_path_style=self.with_path_style,
            client=self.client,
        )


def read(path: str, minio_settings: MinIOSettings | Any = None, **kwargs: Any):
    settings = (
        minio_settings.create_aws_settings()
        if isinstance(minio_settings, MinIOSettings)
        else minio_settings
    )
    return _s3.read(path, settings, **kwargs)


def write(table, path: str, minio_settings: MinIOSettings | Any = None, **kwargs: Any):
    settings = (
        minio_settings.create_aws_settings()
        if isinstance(minio_settings, MinIOSettings)
        else minio_settings
    )
    return _s3.write(table, path, settings, **kwargs)
