"""Conversation templates (FastChat-style prompt assembly): a copy of
``unimp_tpu/serve/conversation.py``.

Parity with the reference's pipeline/conversation.py: a Conversation
dataclass accumulates (role, message) turns and renders the model prompt
under a separator style; templates are registered by name: "v1"
(vicuna-style with the seeded example turn), "bair_v1", "otter" (the
reference default), "open_flamingo", plus this framework's "unimp" and
"plain".

Reference quirks kept on purpose:
  * SeparatorStyle.TWO drops role labels entirely (the reference
    hard-codes ``role = None`` inside the TWO renderer), so turns render
    as ``{message}{sep_i}`` with nothing emitted for an empty turn.
  * A message may be a tuple (text, images, ...); only element 0 is
    rendered.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Tuple


class SeparatorStyle(enum.Enum):
    SINGLE = enum.auto()
    TWO = enum.auto()


@dataclasses.dataclass
class Conversation:
    system: str
    roles: Tuple[str, str]
    messages: List[List[Optional[str]]]
    offset: int = 0
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "\n"
    sep2: str = "</s>"

    def get_prompt(self) -> str:
        if self.sep_style == SeparatorStyle.SINGLE:
            out = self.system + self.sep
            for role, msg in self.messages:
                if msg:
                    if isinstance(msg, tuple):
                        msg = msg[0]
                    out += f"{role}: {msg}{self.sep}"
                else:
                    out += f"{role}:"
            return out
        if self.sep_style == SeparatorStyle.TWO:
            # role labels are dropped (reference conversation.py:45) and
            # empty turns emit nothing
            seps = [self.sep, self.sep2]
            out = self.system + seps[0]
            for i, (role, msg) in enumerate(self.messages):
                if msg:
                    if isinstance(msg, tuple):
                        msg = msg[0]
                    out += f"{msg}{seps[i % 2]}"
            return out
        raise ValueError(self.sep_style)

    def append_message(self, role: str, message: Optional[str]):
        self.messages.append([role, message])

    def to_gradio_chatbot(self):
        """(user, assistant) pairs for chat UIs."""
        ret = []
        for i, (_, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[r, m] for r, m in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
        )

    def dict(self):
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": self.messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


_V1_SYSTEM = (
    "A chat between a curious human and an artificial intelligence "
    "assistant. The assistant gives helpful, detailed, and polite answers "
    "to the human's questions."
)

# conv_v1_2's seeded example exchange (conversation.py:192-224) — the
# reference registers it under the name "v1".
_V1_SEED = [
    ["Human", "What are the key differences between renewable and "
              "non-renewable energy sources?"],
    ["Assistant",
     "Renewable energy sources are those that can be replenished naturally "
     "in a relatively short amount of time, such as solar, wind, hydro, "
     "geothermal, and biomass. Non-renewable energy sources, on the other "
     "hand, are finite and will eventually be depleted, such as coal, oil, "
     "and natural gas. Here are some key differences between renewable and "
     "non-renewable energy sources:\n"
     "1. Availability: Renewable energy sources are virtually "
     "inexhaustible, while non-renewable energy sources are finite and "
     "will eventually run out.\n"
     "2. Environmental impact: Renewable energy sources have a much lower "
     "environmental impact than non-renewable sources, which can lead to "
     "air and water pollution, greenhouse gas emissions, and other "
     "negative effects.\n"
     "3. Cost: Renewable energy sources can be more expensive to initially "
     "set up, but they typically have lower operational costs than "
     "non-renewable sources.\n"
     "4. Reliability: Renewable energy sources are often more reliable and "
     "can be used in more remote locations than non-renewable sources.\n"
     "5. Flexibility: Renewable energy sources are often more flexible and "
     "can be adapted to different situations and needs, while "
     "non-renewable sources are more rigid and inflexible.\n"
     "6. Sustainability: Renewable energy sources are more sustainable "
     "over the long term, while non-renewable sources are not, and their "
     "depletion can lead to economic and social instability.\n"],
]

CONV_TEMPLATES = {
    "unimp": Conversation(
        system=(
            "You are a personalized shopping assistant. Given a user's "
            "interaction history with item images, answer questions about "
            "recommendations, search, ratings and item selection."
        ),
        roles=("User", "Assistant"),
        messages=[],
    ),
    "plain": Conversation(system="", roles=("", ""), messages=[]),
    # reference zoo (conversation.py:260-266)
    "v1": Conversation(
        system=_V1_SYSTEM, roles=("Human", "Assistant"),
        messages=[list(m) for m in _V1_SEED], offset=2,
        sep_style=SeparatorStyle.SINGLE, sep="###",
    ),
    "bair_v1": Conversation(
        system="BEGINNING OF CONVERSATION:", roles=("USER", "GPT"),
        messages=[], offset=0, sep_style=SeparatorStyle.TWO,
        sep=" ", sep2="</s>",
    ),
    "otter": Conversation(  # the reference's default_conversation
        system="", roles=("User", "GPT"), messages=[], offset=0,
        sep_style=SeparatorStyle.TWO, sep=" ", sep2="</s>",
    ),
    "open_flamingo": Conversation(
        system="", roles=("", ""), messages=[], offset=0,
        sep_style=SeparatorStyle.TWO, sep="", sep2="</s>",
    ),
}

default_conversation = CONV_TEMPLATES["otter"]


def get_conv_template(name: str) -> Conversation:
    return CONV_TEMPLATES[name].copy()
