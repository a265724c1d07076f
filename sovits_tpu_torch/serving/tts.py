"""Edge-TTS input bridge (counterpart of ``sovits_tpu/serving/tts.py``;
so-vits-svc edgetts/tts.py + tts_voices.py). Host code, copied: the port
keeps its own copy of what it needs from the JAX package.

Synthesizes TTS audio to feed the converter, with the reference's full
voice catalogue and automatic language detection (edgetts/tts.py:13-23:
langdetect when lang == "Auto", random voice of the requested gender for
the detected locale). Requires the optional ``edge_tts`` package and
network access; when unavailable, point the pipeline at a pre-synthesized
wav instead.

The catalogue below is the public Microsoft Edge neural-voice list (the
same set the reference ships), stored compactly as locale -> voice short
names; full ids are "{locale}-{name}Neural".
"""

from __future__ import annotations

import asyncio
import random

VOICES_BY_LOCALE: dict[str, tuple[str, ...]] = {
    "zh-CN": ('Xiaoxiao', 'Xiaoyi', 'Yunjian', 'Yunxi', 'Yunxia', 'Yunyang'),
    "zh-HK": ('HiuGaai', 'HiuMaan', 'WanLung'),
    "zh-TW": ('HsiaoChen', 'YunJhe', 'HsiaoYu'),
    "af-ZA": ('Adri', 'Willem'),
    "am-ET": ('Ameha', 'Mekdes'),
    "ar-AE": ('Fatima', 'Hamdan'),
    "ar-BH": ('Ali', 'Laila'),
    "ar-DZ": ('Amina', 'Ismael'),
    "ar-EG": ('Salma', 'Shakir'),
    "ar-IQ": ('Bassel', 'Rana'),
    "ar-JO": ('Sana', 'Taim'),
    "ar-KW": ('Fahed', 'Noura'),
    "ar-LB": ('Layla', 'Rami'),
    "ar-LY": ('Iman', 'Omar'),
    "ar-MA": ('Jamal', 'Mouna'),
    "ar-OM": ('Abdullah', 'Aysha'),
    "ar-QA": ('Amal', 'Moaz'),
    "ar-SA": ('Hamed', 'Zariyah'),
    "ar-SY": ('Amany', 'Laith'),
    "ar-TN": ('Hedi', 'Reem'),
    "ar-YE": ('Maryam', 'Saleh'),
    "az-AZ": ('Babek', 'Banu'),
    "bg-BG": ('Borislav', 'Kalina'),
    "bn-BD": ('Nabanita', 'Pradeep'),
    "bn-IN": ('Bashkar', 'Tanishaa'),
    "bs-BA": ('Goran', 'Vesna'),
    "ca-ES": ('Enric', 'Joana'),
    "cs-CZ": ('Antonin', 'Vlasta'),
    "cy-GB": ('Aled', 'Nia'),
    "da-DK": ('Christel', 'Jeppe'),
    "de-AT": ('Ingrid', 'Jonas'),
    "de-CH": ('Jan', 'Leni'),
    "de-DE": ('Amala', 'Conrad', 'Katja', 'Killian'),
    "el-GR": ('Athina', 'Nestoras'),
    "en-AU": ('Natasha', 'William'),
    "en-CA": ('Clara', 'Liam'),
    "en-GB": ('Libby', 'Maisie', 'Ryan', 'Sonia', 'Thomas'),
    "en-HK": ('Sam', 'Yan'),
    "en-IE": ('Connor', 'Emily'),
    "en-IN": ('Neerja', 'Prabhat'),
    "en-KE": ('Asilia', 'Chilemba'),
    "en-NG": ('Abeo', 'Ezinne'),
    "en-NZ": ('Mitchell', 'Molly'),
    "en-PH": ('James', 'Rosa'),
    "en-SG": ('Luna', 'Wayne'),
    "en-TZ": ('Elimu', 'Imani'),
    "en-US": ('Ana', 'Aria', 'Christopher', 'Eric', 'Guy', 'Jenny', 'Michelle'),
    "en-ZA": ('Leah', 'Luke'),
    "es-AR": ('Elena', 'Tomas'),
    "es-BO": ('Marcelo', 'Sofia'),
    "es-CL": ('Catalina', 'Lorenzo'),
    "es-CO": ('Gonzalo', 'Salome'),
    "es-CR": ('Juan', 'Maria'),
    "es-CU": ('Belkys', 'Manuel'),
    "es-DO": ('Emilio', 'Ramona'),
    "es-EC": ('Andrea', 'Luis'),
    "es-ES": ('Alvaro', 'Elvira', 'ManuelEsCU'),
    "es-GQ": ('Javier', 'Teresa'),
    "es-GT": ('Andres', 'Marta'),
    "es-HN": ('Carlos', 'Karla'),
    "es-MX": ('Dalia', 'Jorge', 'LorenzoEsCL'),
    "es-NI": ('Federico', 'Yolanda'),
    "es-PA": ('Margarita', 'Roberto'),
    "es-PE": ('Alex', 'Camila'),
    "es-PR": ('Karina', 'Victor'),
    "es-PY": ('Mario', 'Tania'),
    "es-SV": ('Lorena', 'Rodrigo'),
    "es-US": ('Alonso', 'Paloma'),
    "es-UY": ('Mateo', 'Valentina'),
    "es-VE": ('Paola', 'Sebastian'),
    "et-EE": ('Anu', 'Kert'),
    "fa-IR": ('Dilara', 'Farid'),
    "fi-FI": ('Harri', 'Noora'),
    "fil-PH": ('Angelo', 'Blessica'),
    "fr-BE": ('Charline', 'Gerard'),
    "fr-CA": ('Antoine', 'Jean', 'Sylvie'),
    "fr-CH": ('Ariane', 'Fabrice'),
    "fr-FR": ('Denise', 'Eloise', 'Henri'),
    "ga-IE": ('Colm', 'Orla'),
    "gl-ES": ('Roi', 'Sabela'),
    "gu-IN": ('Dhwani', 'Niranjan'),
    "he-IL": ('Avri', 'Hila'),
    "hi-IN": ('Madhur', 'Swara'),
    "hr-HR": ('Gabrijela', 'Srecko'),
    "hu-HU": ('Noemi', 'Tamas'),
    "id-ID": ('Ardi', 'Gadis'),
    "is-IS": ('Gudrun', 'Gunnar'),
    "it-IT": ('Diego', 'Elsa', 'Isabella'),
    "ja-JP": ('Keita', 'Nanami'),
    "jv-ID": ('Dimas', 'Siti'),
    "ka-GE": ('Eka', 'Giorgi'),
    "kk-KZ": ('Aigul', 'Daulet'),
    "km-KH": ('Piseth', 'Sreymom'),
    "kn-IN": ('Gagan', 'Sapna'),
    "ko-KR": ('InJoon', 'SunHi'),
    "lo-LA": ('Chanthavong', 'Keomany'),
    "lt-LT": ('Leonas', 'Ona'),
    "lv-LV": ('Everita', 'Nils'),
    "mk-MK": ('Aleksandar', 'Marija'),
    "ml-IN": ('Midhun', 'Sobhana'),
    "mn-MN": ('Bataa', 'Yesui'),
    "mr-IN": ('Aarohi', 'Manohar'),
    "ms-MY": ('Osman', 'Yasmin'),
    "mt-MT": ('Grace', 'Joseph'),
    "my-MM": ('Nilar', 'Thiha'),
    "nb-NO": ('Finn', 'Pernille'),
    "ne-NP": ('Hemkala', 'Sagar'),
    "nl-BE": ('Arnaud', 'Dena'),
    "nl-NL": ('Colette', 'Fenna', 'Maarten'),
    "pl-PL": ('Marek', 'Zofia'),
    "ps-AF": ('GulNawaz', 'Latifa'),
    "pt-BR": ('Antonio', 'Francisca'),
    "pt-PT": ('Duarte', 'Raquel'),
    "ro-RO": ('Alina', 'Emil'),
    "ru-RU": ('Dmitry', 'Svetlana'),
    "si-LK": ('Sameera', 'Thilini'),
    "sk-SK": ('Lukas', 'Viktoria'),
    "sl-SI": ('Petra', 'Rok'),
    "so-SO": ('Muuse', 'Ubax'),
    "sq-AL": ('Anila', 'Ilir'),
    "sr-RS": ('Nicholas', 'Sophie'),
    "su-ID": ('Jajang', 'Tuti'),
    "sv-SE": ('Mattias', 'Sofie'),
    "sw-KE": ('Rafiki', 'Zuri'),
    "sw-TZ": ('Daudi', 'Rehema'),
    "ta-IN": ('Pallavi', 'Valluvar'),
    "ta-LK": ('Kumar', 'Saranya'),
    "ta-MY": ('Kani', 'Surya'),
    "ta-SG": ('Anbu', 'Venba'),
    "te-IN": ('Mohan', 'Shruti'),
    "th-TH": ('Niwat', 'Premwadee'),
    "tr-TR": ('Ahmet', 'Emel'),
    "uk-UA": ('Ostap', 'Polina'),
    "ur-IN": ('Gul', 'Salman'),
    "ur-PK": ('Asad', 'Uzma'),
    "uz-UZ": ('Madina', 'Sardor'),
    "vi-VN": ('HoaiMy', 'NamMinh'),
    "zu-ZA": ('Thando', 'Themba'),
}

# flat {full_voice_id: locale} view, the reference's SUPPORTED_VOICES shape
SUPPORTED_VOICES: dict[str, str] = {
    f"{loc}-{name}Neural": loc
    for loc, names in VOICES_BY_LOCALE.items()
    for name in names
}

# langdetect codes -> edge locales for ambiguous/regionless detections
_LANG_TO_LOCALE = {
    "zh-cn": "zh-CN", "zh-tw": "zh-TW", "en": "en-US", "ja": "ja-JP",
    "ko": "ko-KR", "de": "de-DE", "fr": "fr-FR", "es": "es-ES",
    "it": "it-IT", "pt": "pt-BR", "ru": "ru-RU", "ar": "ar-EG",
    "hi": "hi-IN", "id": "id-ID", "vi": "vi-VN", "th": "th-TH",
    "tr": "tr-TR", "pl": "pl-PL", "nl": "nl-NL", "uk": "uk-UA",
}


def detect_language(text: str) -> str:
    """Auto language pick (edgetts/tts.py:12: langdetect with seed 0);
    falls back to a Unicode-range heuristic when langdetect is absent."""
    try:
        from langdetect import DetectorFactory, detect

        DetectorFactory.seed = 0
        return detect(text)
    except ImportError:
        pass
    for ch in text:
        o = ord(ch)
        if 0x3040 <= o <= 0x30FF:
            return "ja"
        if 0xAC00 <= o <= 0xD7AF:
            return "ko"
        if 0x4E00 <= o <= 0x9FFF:
            return "zh-cn"
        if 0x0400 <= o <= 0x04FF:
            return "ru"
        if 0x0600 <= o <= 0x06FF:
            return "ar"
    return "en"


def pick_voice(lang: str, gender: str | None = None, seed: int | None = None) -> str:
    """Resolve (language, gender) -> a concrete voice id.

    Mirrors the reference's random gendered pick within the locale
    (edgetts/tts.py:23-32); without a catalogued locale falls back to en-US.
    Gendered selection uses the convention that the catalogue alternates
    female/male per locale; explicit voice ids pass through unchanged.
    """
    if lang in SUPPORTED_VOICES:  # already a full voice id
        return lang
    locale = _LANG_TO_LOCALE.get(lang.lower(), lang)
    if locale not in VOICES_BY_LOCALE:
        # try to match any locale with the same language prefix
        prefix = locale.split("-")[0].lower()
        locale = next(
            (k for k in VOICES_BY_LOCALE if k.lower().startswith(prefix)), "en-US"
        )
    names = VOICES_BY_LOCALE[locale]
    rng = random.Random(seed)
    return f"{locale}-{rng.choice(names)}Neural"


def synthesize(text: str, output_path: str, lang: str = "Auto",
               gender: str | None = None, rate: str = "+0%",
               volume: str = "+0%", seed: int | None = None) -> str:
    """Text -> wav via edge-tts (edgetts/tts.py equivalent, in-process
    instead of a subprocess). lang may be "Auto", a language code, a
    locale, or a full voice id."""
    try:
        import edge_tts
    except ImportError as e:
        raise ImportError(
            "edge_tts is not installed (and this environment has no network "
            "egress); synthesize TTS input elsewhere and pass the wav to the "
            "converter instead"
        ) from e

    if lang == "Auto":
        lang = detect_language(text)

    async def _run():
        if gender is not None:
            # gendered pick queries the live voice catalogue, exactly
            # edgetts/tts.py:23-32 (VoicesManager.find + random.choice)
            from edge_tts import VoicesManager

            voices = await VoicesManager.create()
            if lang.lower() in ("zh-cn", "zh-tw"):
                locale = lang[:-2] + lang[-2:].upper()
                found = voices.find(Gender=gender, Locale=locale)
            else:
                found = voices.find(Gender=gender, Language=lang)
            voice = random.Random(seed).choice(found)["Name"]
        else:
            voice = pick_voice(lang, gender, seed)
        tts = edge_tts.Communicate(text=text, voice=voice, rate=rate, volume=volume)
        await tts.save(output_path)

    asyncio.run(_run())
    return output_path
