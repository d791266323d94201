"""OpenRouter chat-completions client for the informalization stage, on the
standard library (lean_explore_tpu/util/openrouter_client.py, which uses
httpx and tenacity).

The same request and retry as the JAX client: ``POST
{base_url}/chat/completions`` with the model, one user message and the
temperature (and ``max_tokens`` when given), Bearer auth from the argument
or OPENROUTER_API_KEY (ValueError without either), the message content
returned; any failure is retried, 3 attempts in all, after waits of
tenacity's ``wait_exponential(multiplier=1, min=2, max=30)``, and the last
failure is raised. Each request runs ``urllib.request`` in a thread of
the client's own pool of THREADS (httpx's default connection limit; the
event loop's default pool has only a dozen), and ``informalize``'s
semaphore bounds the requests in flight. The JAX client's ``transport=``
hook belongs to httpx and has no counterpart here.
"""

import asyncio
import json
import logging
import os
import urllib.request
from concurrent.futures import ThreadPoolExecutor

logger = logging.getLogger(__name__)

OPENROUTER_BASE_URL = "https://openrouter.ai/api/v1"
ATTEMPTS = 3
THREADS = 100


def backoff_seconds(failures: int) -> float:
    """The wait after the ``failures``-th failed attempt: tenacity's
    ``wait_exponential(multiplier=1, min=2, max=30)``."""
    return min(max(2.0 ** (failures - 1), 2.0), 30.0)


class OpenRouterClient:
    """Async chat-completions client against the OpenRouter API."""

    def __init__(
        self,
        api_key: str | None = None,
        base_url: str = OPENROUTER_BASE_URL,
        timeout: float = 120.0,
    ):
        self.api_key = api_key or os.getenv("OPENROUTER_API_KEY", "")
        if not self.api_key:
            raise ValueError(
                "OpenRouter API key required. Pass api_key or set "
                "OPENROUTER_API_KEY."
            )
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._pool = ThreadPoolExecutor(max_workers=THREADS, thread_name_prefix="openrouter")

    def _post(self, payload: dict) -> str:
        request = urllib.request.Request(
            f"{self.base_url}/chat/completions",
            data=json.dumps(payload).encode("utf-8"),
            headers={
                "Authorization": f"Bearer {self.api_key}",
                "Content-Type": "application/json",
            },
            method="POST",
        )
        with urllib.request.urlopen(request, timeout=self.timeout) as response:
            data = json.loads(response.read())
        return data["choices"][0]["message"]["content"]

    async def generate(
        self,
        prompt: str,
        model: str,
        temperature: float = 0.3,
        max_tokens: int | None = None,
    ) -> str:
        """One chat completion; returns the message content."""
        payload: dict = {
            "model": model,
            "messages": [{"role": "user", "content": prompt}],
            "temperature": temperature,
        }
        if max_tokens is not None:
            payload["max_tokens"] = max_tokens
        loop = asyncio.get_running_loop()
        for attempt in range(1, ATTEMPTS):
            try:
                return await loop.run_in_executor(self._pool, self._post, payload)
            except Exception as error:  # noqa: BLE001 — tenacity retries any error
                wait = backoff_seconds(attempt)
                logger.debug("OpenRouter attempt %d failed (%s); retrying in %.0f s",
                             attempt, error, wait)
                await asyncio.sleep(wait)
        return await loop.run_in_executor(self._pool, self._post, payload)
